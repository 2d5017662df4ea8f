"""The port's kernel modules against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through ``repro`` (Pallas in
interpret mode, as its own tests run it) and through ``repro_torch`` (whose
wrappers run the kernels' plain PyTorch versions for CPU tensors).
Tolerances are those of the JAX package's own kernel tests: FlashAssign
ids equal and scores ``rtol=atol=1e-4``, sort-inverse counts equal and
sums ``rtol=1e-5, atol=1e-4``, FlashLloyd sums ``rtol=atol=1e-4`` and
inertia ``rtol=1e-4``; bf16 assignments may differ only on near-ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_assign as fa
from repro_torch.kernels import flash_lloyd as fl
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sort_inverse_update as siu
from tests.conftest import assert_assignments_match

SHAPES = [(100, 7, 3), (1000, 37, 19), (513, 100, 33), (4096, 64, 64),
          (333, 17, 57)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _data(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


def _both(arr, dt):
    """The same array as a port tensor and a JAX array of one dtype."""
    tdt, jdt = DTYPES[dt]
    return torch.from_numpy(arr).to(tdt), jnp.asarray(arr, jdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# --- oracles -------------------------------------------------------------

def test_ref_oracles_match_jax():
    x, c = _data(600, 23, 12, seed=1)
    a = np.random.default_rng(2).integers(0, 23, 600).astype(np.int32)
    tx, tc, ta = torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(a)
    np.testing.assert_allclose(_np(ref.pairwise_sq_dists(tx, tc)),
                               _np(jref.pairwise_sq_dists(x, c)),
                               rtol=1e-5, atol=1e-4)
    for mine, theirs in ((ref.assign_ref, jref.assign_ref),
                         (ref.assign_ref_crossterm,
                          jref.assign_ref_crossterm)):
        (pa, pm), (ja, jm) = mine(tx, tc), theirs(x, c)
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm),
                                   rtol=1e-5, atol=1e-4)
    for mine, theirs in ((ref.update_scatter_ref, jref.update_scatter_ref),
                         (ref.update_dense_onehot_ref,
                          jref.update_dense_onehot_ref)):
        (ps, pc), (js, jc) = mine(tx, ta, 23), theirs(x, a, 23)
        assert np.array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(ps.numpy(), np.asarray(js),
                                   rtol=1e-5, atol=1e-4)
    pa, ps, pc, pj = ref.lloyd_stats_ref(tx, tc)
    ja, js, jc, jj = jref.lloyd_stats_ref(x, c)
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(float(pj), float(jj), rtol=1e-5)
    a_empty = np.where(a == 3, 4, a).astype(np.int32)  # cluster 3 empty
    np.testing.assert_allclose(
        ref.centroid_update_ref(tx, torch.from_numpy(a_empty), tc).numpy(),
        np.asarray(jref.centroid_update_ref(x, a_empty, c)),
        rtol=1e-5, atol=1e-5)


# --- FlashAssign ---------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,d", SHAPES)
def test_flash_assign_matches_jax(n, k, d, dt):
    x, c = _data(n, k, d)
    (tx, jx), (tc, jc) = _both(x, dt), _both(c, dt)
    pa, pm = ops.flash_assign(tx, tc)
    ja, jm = jops.flash_assign(jx, jc)
    if dt == "f32":
        assert np.array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm),
                                   rtol=1e-4, atol=1e-4)
        ps, js = (ops.flash_assign(tx, tc, want_dists=False)[1],
                  jops.flash_assign(jx, jc, want_dists=False)[1])
        np.testing.assert_allclose(ps.numpy(), np.asarray(js),
                                   rtol=1e-4, atol=1e-4)
    else:
        assert_assignments_match(jx.astype(jnp.float32),
                                 jc.astype(jnp.float32), pa.numpy(), ja,
                                 tol=0.2)
    assert pa.dtype == torch.int32 and pm.dtype == torch.float32
    assert bool((pm >= 0).all())


def test_flash_assign_duplicate_centroids_go_to_lower_index():
    x, c = _data(700, 20, 9, seed=3)
    c[7] = c[2]
    c[15] = c[2]
    c[19] = c[11]
    pa, _ = ops.flash_assign(torch.from_numpy(x), torch.from_numpy(c))
    ja, _ = jops.flash_assign(x, c)
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    assert not np.isin(pa.numpy(), [7, 15, 19]).any()
    assert np.isin(pa.numpy(), [2, 11]).any()


def test_flash_assign_points_on_centroids():
    c = np.random.default_rng(4).standard_normal((13, 7)).astype(np.float32)
    x = np.tile(c, (4, 1))
    pa, pm = ops.flash_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert np.array_equal(pa.numpy(), np.tile(np.arange(13), 4))
    np.testing.assert_allclose(pm.numpy(), 0.0, atol=1e-4)


def test_flash_assign_batched_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 128, 8)).astype(np.float32)
    c = rng.standard_normal((3, 16, 8)).astype(np.float32)
    pa, pm = ops.flash_assign_batched(torch.from_numpy(x),
                                      torch.from_numpy(c))
    ja, jm = jops.flash_assign_batched(x, c)
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-4,
                               atol=1e-4)


# --- sort-inverse update -------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,d", [(64, 4, 2), (1000, 37, 19),
                                   (513, 100, 33), (100, 1000, 7),
                                   (2048, 512, 64),
                                   # K = 1: every id equal, one segment over
                                   # every chunk; K > N, most clusters empty;
                                   # d = 129 and d = 1 off the vector width
                                   (2048, 1, 8), (50, 4000, 3),
                                   (1500, 40, 129), (31, 5, 1)])
def test_sort_inverse_matches_jax(n, k, d, dt):
    x, _ = _data(n, k, d, seed=6)
    a = np.random.default_rng(7).integers(0, k, n).astype(np.int32)
    tx, jx = _both(x, dt)
    ps, pc = ops.sort_inverse_update(tx, torch.from_numpy(a), k=k)
    js, jc = jops.sort_inverse_update(jx, a, k=k)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    assert ps.shape == (k, d) and pc.shape == (k,)


def test_sort_inverse_empty_clusters_exact_zero():
    x, _ = _data(100, 50, 3)
    a = np.full((100,), 7, np.int32)
    ps, pc = ops.sort_inverse_update(torch.from_numpy(x),
                                     torch.from_numpy(a), k=50)
    js, jc = jops.sort_inverse_update(x, a, k=50)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert pc[7] == 100 and float(pc.sum()) == 100
    assert bool((ps[torch.arange(50) != 7] == 0).all())
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)


def test_sort_inverse_hot_cluster_skew():
    x, _ = _data(1000, 64, 16, seed=8)
    a = np.minimum(np.random.default_rng(9).geometric(0.5, 1000) - 1,
                   63).astype(np.int32)
    ps, pc = ops.sort_inverse_update(torch.from_numpy(x),
                                     torch.from_numpy(a), k=64)
    js, jc = jops.sort_inverse_update(x, a, k=64)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)


def test_sort_inverse_batched_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 300, 6)).astype(np.float32)
    a = rng.integers(0, 11, (3, 300)).astype(np.int32)
    ps, pc = ops.sort_inverse_update_batched(torch.from_numpy(x),
                                             torch.from_numpy(a), k=11)
    js, jc = jops.sort_inverse_update_batched(x, a, k=11)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)


# --- FlashLloyd ----------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n,k,d", SHAPES)
def test_flash_lloyd_matches_jax(n, k, d, dt):
    x, c = _data(n, k, d, seed=11)
    (tx, jx), (tc, jc) = _both(x, dt), _both(c, dt)
    pa, ps, pc, pj = ops.flash_lloyd_step(tx, tc)
    ja, js, jcnt, jj = jops.flash_lloyd_step(jx, jc)
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
        # statistics of the port's own assignments, by the JAX oracle
        rs, rc = jref.update_dense_onehot_ref(jx, pa.numpy(), k)
        assert np.array_equal(pc.numpy(), np.asarray(rc))
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(pj), float(jj), rtol=1e-3)
    assert float(pc.sum()) == n


def test_flash_lloyd_empty_cluster_and_ties():
    x, _ = _data(200, 1, 5, seed=12)
    c = np.concatenate([x[:7], x[2:3], np.full((1, 5), 100.0, np.float32)])
    pa, ps, pc, pj = ops.flash_lloyd_step(torch.from_numpy(x),
                                          torch.from_numpy(c))
    ja, js, jcnt, jj = jops.flash_lloyd_step(x, c)
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    assert not bool((pa == 7).any()) and not bool((pa == 8).any())
    assert float(pc[7]) == 0.0 and float(pc[8]) == 0.0
    assert bool((ps[7:] == 0).all())
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)


def test_finalize_centroids_matches_jax():
    rng = np.random.default_rng(13)
    s = rng.standard_normal((6, 4)).astype(np.float32)
    cnt = np.array([3.0, 0.0, 0.25, 1.0, 0.0, 7.5], np.float32)  # fractional
    c_prev = rng.standard_normal((6, 4)).astype(np.float32)
    mine = ops.finalize_centroids(torch.from_numpy(s), torch.from_numpy(cnt),
                                  torch.from_numpy(c_prev))
    theirs = jops.finalize_centroids(s, cnt, c_prev)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6)
    assert np.array_equal(mine.numpy()[[1, 4]], c_prev[[1, 4]])


# --- wrapper contract ----------------------------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(10, 4)
    with pytest.raises(TypeError):
        fa.flash_assign_raw(x[None].double(), x[None, :3].double())
    with pytest.raises(TypeError):
        fa.flash_assign_raw(x[None], x[None, :3].bfloat16())
    with pytest.raises(ValueError):
        fa.flash_assign_raw(x[None], torch.randn(1, 3, 5))
    for bn, bk in ((64, 64), (128, 64)):   # not the compiled 128 x 128
        with pytest.raises(ValueError, match="compiled"):
            ops.flash_assign(x, x[:3], block_n=bn, block_k=bk)
    with pytest.raises(ValueError):
        ops.sort_inverse_update(x, torch.zeros(10, dtype=torch.int32), k=2,
                                block_n=256, block_k=48)
    with pytest.raises(TypeError):
        siu.sort_inverse_update_raw(x, torch.zeros(10, dtype=torch.int64),
                                    torch.zeros(10, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="two-pass"):   # past C = 8's window
        ops.flash_lloyd_step(torch.randn(8, 128), torch.randn(1337, 128))


def test_cpu_tensors_take_the_plain_versions():
    before = (fa.launches, siu.launches, fl.launches)
    x, c = torch.randn(300, 8), torch.randn(9, 8)
    a, _ = ops.flash_assign(x, c)
    ops.sort_inverse_update(x, a, k=9)
    ops.flash_lloyd_step(x, c)
    assert (fa.launches, siu.launches, fl.launches) == before
    pa, pm = fa.flash_assign_plain(x[None], c[None])
    assert torch.equal(pa[0], a)
