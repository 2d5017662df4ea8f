"""FlashLloyd's fused step against the JAX package's, on the CPU, at the shapes
where the kernel's layout changes: K at the edge of each cluster size's
window at d = 128 (``core.heuristics.max_fused_k``), clustered data at
K = 16, and a batch whose sums need a cluster of 2. The port's wrapper runs
its plain version here; the same numpy inputs go through the JAX package's
``flash_lloyd_step`` (Pallas interpret mode). Tolerances are those of
``test_torch_kernels.test_flash_lloyd_matches_jax``: f32 ids and counts
equal, sums ``rtol=atol=1e-4``, inertia ``rtol=1e-4``; bf16 ids equal but
on near-ties, sums and counts against the JAX oracle on the port's own ids,
inertia ``rtol=1e-3``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import heuristics as H
from repro_torch.kernels import ops
from tests.conftest import assert_assignments_match

DTYPES = {"f32": (torch.float32, jnp.float32, 4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2)}


def _both(arr, dt):
    tdt, jdt, _ = DTYPES[dt]
    return torch.from_numpy(arr).to(tdt), jnp.asarray(arr, jdt)


def _check(x, c, dt, port=None):
    """The port's fused step (or ``port``, its result for this problem)
    against the JAX package's on the same inputs."""
    (tx, jx), (tc, jc) = _both(x, dt), _both(c, dt)
    pa, ps, pc, pj = port if port is not None else ops.flash_lloyd_step(tx, tc)
    ja, js, jcnt, jj = jops.flash_lloyd_step(jx, jc)
    k = c.shape[0]
    if dt == "f32":
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        assert np.array_equal(pc.numpy(), np.asarray(jcnt))
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(pj), float(jj), rtol=1e-4)
    else:
        assert_assignments_match(jx.astype(jnp.float32),
                                 jc.astype(jnp.float32), pa.numpy(), ja,
                                 tol=0.2)
        rs, rc = jref.update_dense_onehot_ref(jx, pa.numpy(), k)
        assert np.array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(pj), float(jj), rtol=1e-3)
    assert float(pc.sum()) == x.shape[0]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cluster,over", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_flash_lloyd_at_cluster_edges_matches_jax(dt, cluster, over):
    """The largest K of cluster sizes 1 and 2 at d = 128, and one more
    centroid, where the planner takes the next size."""
    k = H.max_fused_k(128, DTYPES[dt][2], cluster) + over
    assert H.choose_lloyd_cluster(k, 128, DTYPES[dt][2]) == cluster << over
    rng = np.random.default_rng(21 + k)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    c = rng.standard_normal((k, 128)).astype(np.float32)
    _check(x, c, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_lloyd_k16_clustered_matches_jax(dt):
    """K = 16 with every row near one of 3 centroids: most clusters empty,
    long runs of one id."""
    rng = np.random.default_rng(22)
    c = (2.0 * rng.standard_normal((16, 64))).astype(np.float32)
    lab = rng.integers(0, 3, 1500)
    x = (c[lab] + 0.1 * rng.standard_normal((1500, 64))).astype(np.float32)
    _check(x, c, dt)


def test_flash_lloyd_batched_across_a_cluster_matches_jax():
    """B = 3 problems whose K = 300 sums at d = 128 need a cluster of 2, in
    one batched step, each problem against the JAX package's step."""
    assert H.choose_lloyd_cluster(300, 128, 4) == 2
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, 200, 128)).astype(np.float32)
    c = rng.standard_normal((3, 300, 128)).astype(np.float32)
    a, s, cnt, j = ops.flash_lloyd_step_batched(torch.from_numpy(x),
                                                torch.from_numpy(c))
    assert a.shape == (3, 200) and s.shape == (3, 300, 128)
    for i in range(3):
        _check(x[i], c[i], "f32", port=(a[i], s[i], cnt[i], j[i]))
