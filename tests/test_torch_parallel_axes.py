"""The sharded index's other axes on 4 gloo ranks of the CPU, held to the
JAX package's single-device index on the same numpy inputs.

One group of 4 ranks runs ``tests/_torch_parallel_worker.py`` in its
``axes`` mode (it imports ``repro_torch`` only): on a 2x2 mesh (2 data x 2
cell shards) it builds the paged fp32 index, the padded and paged q8
indexes with the device rescore cache and with the host oracle, and the
two-level fp32 and q8 indexes over a router made from numpy arrays; each
adds the corpus, searches at nprobe 4 and K, adds again, refreshes and
searches a ragged batch at nprobe 4 and K. The tests compare every rank's
ids with ``repro.index.IVFIndex`` on one device (same store, codec and
router; a host-oracle case with the reference's device-cache twin, whose
results the reference's host path equals), as the reference's own tests
assert sharded =
single-device (``tests/distributed/test_parallel.py:195-342``): ids equal,
distances within ``RTOL``/``1e-3`` (the two packages sum the expanded form
in different orders). Against the port's own one-device index, which each
rank also runs, ids and distances are bit for bit; and the q8 device cache
is bit for bit its host oracle.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_parallel_worker as W  # noqa: E402

WORLD = 4
RTOL = 1e-5
RESULTS = ["search4", "search16", "after4", "after16"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 4 ranks in ``axes`` mode, wait for all (a time limit, then
    kill), load each rank's results."""
    out = tmp_path_factory.mktemp("axes")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(r), str(WORLD), str(out / "store"), str(out), "axes"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def inp():
    return W.inputs()


def _jax_index(name, inp):
    """The JAX package's single-device index of ``W.AXES[name]`` and its
    results, driven as the worker drives the sharded one."""
    from repro.index import IVFIndex
    from repro.index.router import TwoLevelRouter
    kw = dict(W.AXES[name])
    if "router" in kw:
        kw["router"] = TwoLevelRouter(inp["coarse"], inp["owner"],
                                      nprobe_c=2)
    idx = IVFIndex(jnp.asarray(inp["centers"]), capacity=128, **kw)
    out = {"add": np.asarray(idx.add(jnp.asarray(inp["x"])))}
    for npb in (4, W.K):
        out[f"search{npb}"] = idx.search(jnp.asarray(inp["q"]), topk=10,
                                         nprobe=npb)
    idx.add(jnp.asarray(inp["x2"]))
    idx.refresh()
    for npb in (4, W.K):
        out[f"after{npb}"] = idx.search(jnp.asarray(inp["q_ragged"]),
                                        topk=10, nprobe=npb)
    out["counts"] = np.asarray(idx.counts)
    out["lists"] = np.asarray(idx.posting_lists()[0])
    return out


@pytest.fixture(scope="module")
def ref(inp):
    """The JAX indexes; a host-oracle case reads its device twin's (the
    reference's host and device paths return the same results with an
    unbounded cache, ``repro/index/rescore_cache.py``)."""
    out = {name: _jax_index(name, inp) for name in W.AXES
           if not name.endswith("_host")}
    return {name: out[name.removesuffix("_host")] for name in W.AXES}


def test_every_rank_holds_the_same_results(ranks):
    for r in range(1, WORLD):
        diff = [k for k in ranks[0]
                if not np.array_equal(ranks[0][k], ranks[r][k])]
        assert not diff, f"rank {r} differs from rank 0 in {diff}"


@pytest.mark.parametrize("name", list(W.AXES))
def test_sharded_axes_match_the_jax_index(ranks, ref, name):
    """Ids equal the JAX single-device index's at nprobe 4 and K, before
    and after an add and a refresh; distances within f32 rounding; the
    same cells, counts and posting lists."""
    got, want = ranks[0], ref[name]
    assert np.array_equal(got[f"{name}/add"], want["add"])
    for case in RESULTS:
        ids, dists = (np.asarray(a) for a in want[case])
        assert np.array_equal(got[f"{name}/{case}/ids"], ids), case
        live = ids >= 0
        np.testing.assert_allclose(got[f"{name}/{case}/dists"][live],
                                   dists[live], rtol=RTOL, atol=1e-3)
    assert np.array_equal(got[f"{name}/counts"], want["counts"])
    assert np.array_equal(got[f"{name}/lists"], want["lists"])


@pytest.mark.parametrize("name", list(W.AXES))
def test_sharded_axes_equal_the_ports_one_device_index(ranks, name):
    """Bit for bit the port's one-device index over the same inputs: the
    merges keep the one-device order, ties included, and the q8 row
    exchange carries each row unchanged."""
    got = ranks[0]
    for case in RESULTS:
        for part in ("ids", "dists"):
            key = f"{name}/{case}/{part}"
            assert np.array_equal(got[key], got[f"one/{key}"]), key


@pytest.mark.parametrize("kind", ["q8", "q8_paged"])
def test_the_device_cache_is_bit_for_bit_its_host_oracle(ranks, kind):
    got = ranks[0]
    for case in RESULTS:
        for part in ("ids", "dists"):
            assert np.array_equal(got[f"{kind}/{case}/{part}"],
                                  got[f"{kind}_host/{case}/{part}"])


def test_full_probe_covers_every_group_and_the_modeled_bytes(ranks):
    """At nprobe = K the routed index probes every cell, so it equals the
    flat one; the modeled bytes are the reference's (two merges)."""
    from repro.core.parallel import search_collective_bytes_model
    got = ranks[0]
    for case in ("search16", "after16"):
        assert np.array_equal(got[f"routed/{case}/ids"],
                              got[f"paged/{case}/ids"])
    for name in W.AXES:
        assert int(got[f"{name}/bytes"]) == search_collective_bytes_model(
            64, 4, 10, W.K, 2)
