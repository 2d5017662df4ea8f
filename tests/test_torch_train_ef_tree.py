"""``optim.compression.ef_tree_allreduce`` and ``init_error_tree`` on 4
gloo ranks of the CPU, held to the JAX package's quantizer.

The ranks (``tests/_torch_parallel_worker.py ... ef_tree``) reduce a
three-leaf gradient tree over the ``pod`` axis of a 2x2x1 mesh for three
rounds, feeding each round's residuals into the next. Each leaf's sum must
equal, on both ranks of a pod pair, the sum of the two ranks' residual-
corrected contributions as ``repro.optim.compression`` quantizes and
dequantizes them, bit for bit, and each new residual must be that rank's
quantization error.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LEAVES = ("a", "c", "d")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ef_tree")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(r), str(WORLD), str(out / "store"), str(out), "ef_tree"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _deq(xe):
    from repro.optim import compression as jc
    q, s = jc.quantize_int8(jnp.asarray(xe))
    return np.asarray(jc.dequantize_int8(q, s, xe.shape))


@pytest.mark.parametrize("leaf", LEAVES)
def test_each_leaf_sums_the_pods_dequantized_contributions(ranks, leaf):
    for dd in range(2):
        pair = sorted((r for r in ranks if int(r["data"]) == dd),
                      key=lambda r: int(r["pod"]))
        assert [int(r["pod"]) for r in pair] == [0, 1]
        for i in range(3):
            want = 0.0
            for r in pair:
                want = want + _deq(r[f"{i}/{leaf}/x"] + r[f"{i}/{leaf}/err"])
            for r in pair:
                assert np.array_equal(r[f"{i}/{leaf}/total"], want), (dd, i)


@pytest.mark.parametrize("leaf", LEAVES)
def test_the_residuals_are_the_quantization_error_fed_back(ranks, leaf):
    for r in ranks:
        assert not r[f"0/{leaf}/err"].any()       # init_error_tree: zeros
        assert r[f"0/{leaf}/err"].dtype == np.float32
        for i in range(3):
            xe = r[f"{i}/{leaf}/x"] + r[f"{i}/{leaf}/err"]
            np.testing.assert_array_equal(r[f"{i}/{leaf}/new_err"],
                                          xe - _deq(xe))
            if i:
                np.testing.assert_array_equal(r[f"{i}/{leaf}/err"],
                                              r[f"{i - 1}/{leaf}/new_err"])
