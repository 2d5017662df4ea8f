"""The port's Lloyd loop against the JAX package, on the CPU.

Both packages start from the same initial centroids (drawn by the JAX
k-means++ init from a key and handed to the port as ``c0``) on the same
numpy data, a well-separated Gaussian mixture with one centroid per
component, so no point lies near a boundary and the assignments are
tie-free.
f32: assignments and iteration counts equal, centroids and inertia within
``rtol=atol=1e-5``. bf16: iteration counts equal, assignments equal up to
near-ties, centroids within ``rtol=atol=1e-2`` (a bf16 ulp is 2^-8 of the
value) and inertia within ``rtol=1e-3``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.init import init_centroids as jinit
from repro_torch.core import (KMeans, KMeansConfig, init_centroids,
                              kmeans_plus_plus, lloyd_step, make_kmeans_fn,
                              random_init, state_from_numpy, state_to_numpy)
from tests.conftest import assert_assignments_match

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}

# (step_impl, update_impl): every cell the config allows
STEP_GRID = [("fused", "sort_inverse"), ("two_pass", "sort_inverse"),
             ("two_pass", "scatter"), ("two_pass", "dense_onehot")]


def _mixture(n=2048, k=12, d=16, seed=0, spread=3.0, noise=0.4):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.standard_normal((n, d)) * noise
            ).astype(np.float32)


def _c0(x, k, seed=1):
    return np.array(jinit(jax.random.PRNGKey(seed), jnp.asarray(x), k,
                          "kmeans++"))


def _cfgs(dt, **kw):
    kw.setdefault("init", "kmeans++")
    j = jcore.KMeansConfig(dtype=None if dt == "f32" else JDT[dt], **kw)
    p = KMeansConfig(dtype=None if dt == "f32" else TDT[dt], **kw)
    return j, p


def _compare(jst, pst, x, dt):
    jn = {f: np.asarray(getattr(jst, f), np.float32)
          for f in ("centroids", "inertia", "shift")}
    pn = state_to_numpy(pst)
    assert int(pst.iteration) == int(jst.iteration)
    if dt == "f32":
        assert np.array_equal(pn["assignments"], np.asarray(jst.assignments))
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pn["centroids"], jn["centroids"], **tol)
        np.testing.assert_allclose(pn["inertia"], jn["inertia"], **tol)
    else:
        assert_assignments_match(x, jn["centroids"], pn["assignments"],
                                 jst.assignments, tol=0.2)
        np.testing.assert_allclose(pn["centroids"], jn["centroids"],
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(pn["inertia"], jn["inertia"], rtol=1e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("step_impl,update_impl", STEP_GRID)
def test_fit_matches_jax(step_impl, update_impl, dt):
    x = _mixture()
    jcfg, pcfg = _cfgs(dt, k=12, max_iters=6, tol=1e-4,
                       step_impl=step_impl, update_impl=update_impl)
    jst = jcore.make_kmeans_fn(jcfg)(jax.random.PRNGKey(1), jnp.asarray(x))
    pst = make_kmeans_fn(pcfg)(torch.from_numpy(x),
                               c0=torch.from_numpy(_c0(x, 12)))
    _compare(jst, pst, x, dt)
    assert pst.assignments.dtype == torch.int32
    assert pst.centroids.dtype == TDT[dt]


def test_tol_stops_early_at_the_same_iteration():
    x = _mixture(seed=3)
    jcfg, pcfg = _cfgs("f32", k=12, max_iters=25, tol=1e-3)
    jst = jcore.make_kmeans_fn(jcfg)(jax.random.PRNGKey(1), jnp.asarray(x))
    pst = make_kmeans_fn(pcfg)(torch.from_numpy(x),
                               c0=torch.from_numpy(_c0(x, 12)))
    assert 1 < int(pst.iteration) < 25
    _compare(jst, pst, x, "f32")
    assert float(pst.shift) <= 1e-3


@pytest.mark.parametrize("step_impl", ["fused", "two_pass"])
def test_lloyd_step_matches_jax(step_impl):
    x = _mixture(n=900, k=7, d=10, seed=4)
    c0 = _c0(x, 7, seed=2)
    jcfg, pcfg = _cfgs("f32", k=7, step_impl=step_impl)
    jc, ja, jj = jcore.lloyd_step(jnp.asarray(x), jnp.asarray(c0), jcfg)
    pc, pa, pj = lloyd_step(torch.from_numpy(x), torch.from_numpy(c0), pcfg)
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(pj), float(jj), rtol=1e-5)


@pytest.mark.parametrize("step_impl", ["fused", "two_pass"])
def test_fit_batched_matches_single_fits_and_jax(step_impl):
    xs = np.stack([_mixture(n=600, k=5, d=8, seed=s) for s in (5, 6, 7)])
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    c0 = np.stack([np.array(jinit(keys[b], jnp.asarray(xs[b]), 5,
                                  "kmeans++")) for b in range(3)])
    jcfg, pcfg = _cfgs("f32", k=5, max_iters=6, tol=1e-4,
                       step_impl=step_impl)
    km = KMeans(pcfg, device="cpu")
    pb = km.fit_batched(torch.from_numpy(xs), c0=torch.from_numpy(c0))
    jb = jcore.KMeans(jcfg).fit_batched(jax.random.PRNGKey(3),
                                        jnp.asarray(xs))
    for b in range(3):
        single = km.fit(torch.from_numpy(xs[b]), c0=torch.from_numpy(c0[b]))
        assert int(single.iteration) == int(pb.iteration[b])
        assert torch.equal(single.assignments, pb.assignments[b])
        torch.testing.assert_close(single.centroids, pb.centroids[b],
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(single.inertia, pb.inertia[b],
                                   rtol=1e-5, atol=1e-5)
        assert int(pb.iteration[b]) == int(jb.iteration[b])
        assert np.array_equal(pb.assignments[b].numpy(),
                              np.asarray(jb.assignments[b]))
        np.testing.assert_allclose(pb.centroids[b].numpy(),
                                   np.asarray(jb.centroids[b]),
                                   rtol=1e-5, atol=1e-5)


def test_module_iterate_and_predict_match_jax():
    x = _mixture(n=500, k=6, d=8, seed=8)
    c0 = _c0(x, 6, seed=4)
    jkm = jcore.KMeans(jcore.KMeansConfig(k=6))
    pkm = KMeans(KMeansConfig(k=6), device="cpu")
    jc, ja, jj = jkm.iterate(jnp.asarray(x), jnp.asarray(c0))
    pc, pa, pj = pkm.iterate(torch.from_numpy(x), torch.from_numpy(c0))
    assert np.array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(
        pkm.predict(torch.from_numpy(x), pc).numpy(),
        np.asarray(jkm.predict(jnp.asarray(x), jc)))


CONTRADICTIONS = [
    dict(update_impl="fused", step_impl="two_pass"),
    dict(update_impl="fused", assign_impl="ref"),
    dict(step_impl="fused", assign_impl="ref"),
    dict(step_impl="fused", update_impl="scatter"),
    dict(step_impl="fused", update_impl="dense_onehot"),
    dict(step_impl="nope"),
]


@pytest.mark.parametrize("kw", CONTRADICTIONS)
def test_config_raises_like_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jcore.KMeansConfig(k=4, **kw).resolved_step_impl(100, 8, 4)
    with pytest.raises(ValueError) as perr:
        KMeansConfig(k=4, **kw).resolved_step_impl(100, 8, 4)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(update_impl="fused"), dict(step_impl="fused"),
    dict(update_impl="scatter"), dict(update_impl="dense_onehot"),
    dict(step_impl="two_pass"), dict(assign_impl="ref")])
def test_config_rules_match_jax(kw):
    j, p = jcore.KMeansConfig(k=4, **kw), KMeansConfig(k=4, **kw)
    assert p.stats_only_update_impl() == j.stats_only_update_impl()
    if j.step_impl != "auto" or j.update_impl == "fused" \
            or j.assign_impl != "flash" or j.update_impl != "sort_inverse":
        assert p.resolved_step_impl(100, 8, 4) == \
            j.resolved_step_impl(100, 8, 4)


def test_unknown_impls_raise():
    x = torch.randn(50, 4)
    with pytest.raises(ValueError, match="assign impl"):
        lloyd_step(x, x[:3], KMeansConfig(k=3, assign_impl="bogus",
                                          step_impl="two_pass"))
    with pytest.raises(ValueError, match="update impl"):
        lloyd_step(x, x[:3], KMeansConfig(k=3, update_impl="bogus",
                                          step_impl="two_pass"))
    with pytest.raises(ValueError, match="init method"):
        init_centroids(x, 3, "bogus", generator=torch.Generator())


def test_init_contracts():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 3)
    with pytest.raises(ValueError, match="k=41 > n=40"):
        random_init(x, 41, generator=g)
    c = random_init(x, 40, generator=g)
    assert torch.equal(torch.sort(c[:, 0]).values,
                       torch.sort(x[:, 0]).values)  # distinct rows
    same = torch.ones(30, 4)  # every D² weight becomes zero after one draw
    cpp = kmeans_plus_plus(same, 5, generator=g)
    assert torch.isfinite(cpp).all() and torch.equal(cpp, torch.ones(5, 4))
    two = torch.cat([torch.zeros(20, 2), torch.full((20, 2), 9.0)])
    cpp = kmeans_plus_plus(two, 2, generator=g)
    assert float((cpp[0] - cpp[1]).abs().sum()) == 18.0  # D² picks the far one


def test_fit_draws_its_own_init():
    x = torch.from_numpy(_mixture(n=400, k=4, d=6, seed=9))
    km = KMeans(KMeansConfig(k=4, max_iters=5, init="kmeans++"), device="cpu")
    a = km.fit(x, generator=torch.Generator().manual_seed(7))
    b = km.fit(x, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a.centroids, b.centroids)
    assert 1 <= int(a.iteration) <= 5 and torch.isfinite(a.inertia)


def test_bridge_round_trip_from_jax():
    x = _mixture(n=300, k=5, d=6, seed=10)
    for dt in ("f32", "bf16"):
        jcfg, _ = _cfgs(dt, k=5, max_iters=3)
        jst = jcore.make_kmeans_fn(jcfg)(jax.random.PRNGKey(0),
                                         jnp.asarray(x))
        d = {f: np.asarray(getattr(jst, f)) for f in jst._fields}
        pst = state_from_numpy(d, "cpu")
        assert pst.centroids.dtype == TDT[dt]
        back = state_to_numpy(pst)
        for f in jst._fields:
            np.testing.assert_array_equal(back[f],
                                          np.asarray(d[f], back[f].dtype))
    with pytest.raises(KeyError):
        state_from_numpy({"centroids": np.zeros((2, 2))}, "cpu")
