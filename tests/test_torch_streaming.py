"""The port's streaming driver (``SufficientStats.from_batch``,
``partial_fit_step``, ``StreamingKMeans``) against the JAX package's, on
the CPU.

Both packages get the same numpy inputs: a well-separated Gaussian mixture
near the origin with one centroid per component (so the assignments are
tie-free and equal), and the same starting centroids (the two bootstraps
draw from different generators, so a stream is bootstrapped in one
package and carried to the other by the state bridge). The JAX side runs
its Pallas kernels in interpret mode, the port its kernels' plain versions.
Tolerance (f32): assignments equal; sums, centroids and inertia within
``rtol=atol=1e-5`` of the reference's (the same rows summed in another
order; sums and inertia relative to their magnitude); counts equal, and
decayed counts within ``rtol=1e-5``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro_torch.core import (KMeansConfig, StreamingKMeans, SufficientStats,
                              partial_fit_step, stream_from_numpy,
                              stream_to_numpy)

K, D = 8, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _mixture(n, seed=0, k=K, d=D, spread=3.0, noise=0.4):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((k, d)) * spread).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * noise
    return x.astype(np.float32), centers


def _c0(centers, seed=1):
    rng = np.random.default_rng(seed)
    return (centers + 0.3 * rng.standard_normal(centers.shape)
            ).astype(np.float32)


def _stats_close(ts, js, exact_counts=True):
    """Sums within rtol 1e-5 plus 1e-5 of their largest magnitude; counts
    equal (or, decayed, within rtol 1e-5); inertia within rtol 1e-5."""
    scale = float(np.abs(np.asarray(js.sums)).max())
    np.testing.assert_allclose(ts.sums.numpy(), np.asarray(js.sums),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(ts.counts.numpy(), np.asarray(js.counts),
                               rtol=0 if exact_counts else 1e-5)
    np.testing.assert_allclose(float(ts.inertia), float(js.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("step_impl", ["fused", "two_pass"])
@pytest.mark.parametrize("masked", [False, True])
def test_from_batch_matches_jax(masked, step_impl):
    x, centers = _mixture(600)
    c0 = _c0(centers)
    mask = np.random.default_rng(2).random(600) < 0.6 if masked else None
    jcfg = J.KMeansConfig(k=K, step_impl=step_impl)
    tcfg = KMeansConfig(k=K, step_impl=step_impl)
    js, ja = J.SufficientStats.from_batch(
        jnp.asarray(x), jnp.asarray(c0), jcfg,
        mask=None if mask is None else jnp.asarray(mask))
    ts, ta = SufficientStats.from_batch(
        torch.from_numpy(x), torch.from_numpy(c0), tcfg,
        mask=None if mask is None else torch.from_numpy(mask))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _stats_close(ts, js)
    if masked:   # masked rows carry no evidence
        assert float(ts.counts.sum()) == float(mask.sum())


def test_masked_from_batch_is_the_unmasked_rows_alone():
    x, centers = _mixture(500, seed=3)
    c0 = torch.from_numpy(_c0(centers))
    mask = np.random.default_rng(4).random(500) < 0.5
    cfg = KMeansConfig(k=K)
    ts, ta = SufficientStats.from_batch(torch.from_numpy(x), c0, cfg,
                                        mask=torch.from_numpy(mask))
    sub, sa = SufficientStats.from_batch(torch.from_numpy(x[mask]), c0, cfg)
    np.testing.assert_array_equal(ta.numpy()[mask], sa.numpy())
    np.testing.assert_allclose(ts.sums.numpy(), sub.sums.numpy(), **TOL)
    np.testing.assert_array_equal(ts.counts.numpy(), sub.counts.numpy())
    np.testing.assert_allclose(float(ts.inertia), float(sub.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("local_iters", [1, 3])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_partial_fit_step_matches_jax(decay, local_iters):
    x, centers = _mixture(900, seed=5)
    c0 = _c0(centers)
    prior, batch = x[:400], x[400:]
    jcfg, tcfg = J.KMeansConfig(k=K), KMeansConfig(k=K)
    js0, _ = J.SufficientStats.from_batch(jnp.asarray(prior),
                                          jnp.asarray(c0), jcfg)
    ts0 = SufficientStats(*(torch.from_numpy(np.array(v))
                            for v in (js0.sums, js0.counts, js0.inertia)))
    jc, js, ja, jj = J.partial_fit_step(
        jnp.asarray(batch), jnp.asarray(c0), js0, cfg=jcfg, decay=decay,
        local_iters=local_iters)
    tc, ts, ta, tj = partial_fit_step(
        torch.from_numpy(batch), torch.from_numpy(c0), ts0, cfg=tcfg,
        decay=decay, local_iters=local_iters)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    _stats_close(ts, js, exact_counts=decay == 1.0)
    np.testing.assert_allclose(float(tj), float(jj), rtol=1e-5)


def _jax_stream_state(jsk):
    return {"centroids": np.asarray(jsk.centroids),
            "sums": np.asarray(jsk.stats.sums),
            "counts": np.asarray(jsk.stats.counts),
            "inertia": np.asarray(jsk.stats.inertia),
            "n_batches": np.asarray(jsk.n_batches)}


def _load_jax(jsk, d):
    jsk.centroids = jnp.asarray(d["centroids"])
    jsk.stats = J.SufficientStats(jnp.asarray(d["sums"]),
                                  jnp.asarray(d["counts"]),
                                  jnp.asarray(d["inertia"]))
    jsk.n_batches = int(d["n_batches"])


@pytest.mark.parametrize("start", ["jax", "torch"])
def test_stream_continued_across_the_bridge(start):
    """A stream bootstrapped in one package goes on in the other: both
    continuations from the bridged state agree batch by batch."""
    x, _ = _mixture(1400, seed=6)
    batches = [x[lo:lo + 200] for lo in range(0, 1400, 200)]
    jcfg, tcfg = J.KMeansConfig(k=K, init="kmeans++"), \
        KMeansConfig(k=K, init="kmeans++")
    jsk = J.StreamingKMeans(jcfg, decay=0.9, seed=3)
    tsk = StreamingKMeans(tcfg, decay=0.9, seed=3, device="cpu")
    first = jsk if start == "jax" else tsk
    for b in batches[:3]:
        first.partial_fit(b)
    if start == "jax":
        stream_from_numpy(tsk, _jax_stream_state(jsk))
    else:
        _load_jax(jsk, stream_to_numpy(tsk))
    assert jsk.n_batches == tsk.n_batches == 3
    for b in batches[3:]:
        jsk.partial_fit(b)
        tsk.partial_fit(b)
        np.testing.assert_allclose(tsk.centroids.numpy(),
                                   np.asarray(jsk.centroids), **TOL)
        np.testing.assert_allclose(float(tsk.last_batch_inertia),
                                   float(jsk.last_batch_inertia), rtol=1e-5)
    _stats_close(tsk.stats, jsk.stats, exact_counts=False)
    a_new = x[:300]
    np.testing.assert_array_equal(tsk.update(a_new).numpy(),
                                  np.asarray(jsk.update(a_new)))
    np.testing.assert_allclose(tsk.centroids.numpy(),
                               np.asarray(jsk.centroids), **TOL)
    np.testing.assert_array_equal(tsk.predict(x).numpy(),
                                  np.asarray(jsk.predict(x)))
    np.testing.assert_allclose(tsk.inertia(x), jsk.inertia(x), rtol=1e-5)
    assert jsk.n_batches == tsk.n_batches == 8


def test_init_size_guards_match_jax():
    """Clear errors before the bootstrap; a refused ``update`` keeps
    nothing (a retry would count it twice); every point counts once."""
    x, _ = _mixture(300, seed=7, k=3, d=4)
    jsk = J.StreamingKMeans(J.KMeansConfig(k=3), init_size=250)
    tsk = StreamingKMeans(KMeansConfig(k=3), init_size=250, device="cpu")
    for sk in (jsk, tsk):
        with pytest.raises(ValueError, match="before any partial_fit"):
            sk.inertia(x)
        with pytest.raises(ValueError, match="before any partial_fit"):
            sk.predict(x)
        with pytest.raises(ValueError, match="still buffering"):
            sk.update(x[:100])
        sk.partial_fit(x[:100])                # buffered, not initialized
        with pytest.raises(ValueError, match="200 of 250"):
            sk.update(x[100:200])              # refused and not buffered
        sk.partial_fit(x[100:200])
        assert sk.centroids is None and sk.n_batches == 2
        sk.partial_fit(x[200:300])             # 300 >= 250: bootstrap
        assert sk.centroids is not None and sk.n_batches == 3
        assert float(sk.stats.weight) == pytest.approx(300.0)


def test_update_bootstraps_the_whole_buffer():
    x, _ = _mixture(400, seed=8, k=4, d=6)
    sk = StreamingKMeans(KMeansConfig(k=4), init_size=150, device="cpu")
    sk.partial_fit(x[:100])
    a = sk.update(x[100:200])                  # completes the buffer
    assert a.shape == (200,)                   # ids of the whole buffer
    assert float(sk.stats.weight) == pytest.approx(200.0)
    w0 = float(sk.stats.weight)
    sk.update(x[200:300])                      # full weight, no decay
    assert float(sk.stats.weight) == pytest.approx(w0 + 100)


def test_construction_rules(monkeypatch):
    cfg = KMeansConfig(k=4)
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="decay"):
            StreamingKMeans(cfg, decay=bad, device="cpu")
    # the data-parallel stream is ported (tests/test_torch_parallel*.py);
    # a context that splits the centroids is refused, as in the reference
    with pytest.raises(ValueError, match="data-parallel"):
        StreamingKMeans(cfg, pctx=SimpleNamespace(k_axis="model"),
                        device="cpu")
    data_only = SimpleNamespace(k_axis=None, device=torch.device("cpu"))
    assert StreamingKMeans(cfg, pctx=data_only).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingKMeans(cfg)                   # device=None means the card


def test_streaming_respects_cfg_dtype():
    x, _ = _mixture(300, seed=9, k=3, d=4)
    sk = StreamingKMeans(KMeansConfig(k=3, dtype=torch.bfloat16),
                         device="cpu")
    sk.partial_fit(x)
    assert sk.centroids.dtype == torch.bfloat16
    assert sk.stats.sums.dtype == torch.float32


def test_one_epoch_at_decay_one_is_within_2pct_of_a_lloyd_pass():
    """``decay=1`` over one epoch of disjoint batches telescopes to within
    one re-assignment of a full-batch Lloyd pass from the same start."""
    from repro_torch.core import lloyd_step
    x, centers = _mixture(2048, seed=10)
    c0 = _c0(centers, seed=11)
    cfg = KMeansConfig(k=K)
    c1, _, _ = lloyd_step(torch.from_numpy(x), torch.from_numpy(c0), cfg)
    sk = StreamingKMeans(cfg, device="cpu")
    stream_from_numpy(sk, {"centroids": c0, "sums": np.zeros((K, D)),
                           "counts": np.zeros(K), "inertia": np.zeros(()),
                           "n_batches": 0})
    for lo in range(0, 2048, 256):
        sk.partial_fit(x[lo:lo + 256])
    full = float(SufficientStats.from_batch(torch.from_numpy(x), c1,
                                            cfg)[0].inertia)
    assert sk.inertia(x) <= 1.02 * full, (sk.inertia(x), full)


_READS = ("cpu", "numpy", "item", "tolist", "__bool__", "__float__",
          "__int__")


def _count_host_reads(monkeypatch, fn):
    """Calls of the ``Tensor`` methods that read a value to the host (each
    a device sync on the card) during ``fn()``."""
    calls = {"n": 0}

    def spy(real):
        def wrapped(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        return wrapped
    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, spy(getattr(torch.Tensor,
                                                             name)))
    try:
        fn()
    finally:
        monkeypatch.undo()
    return calls["n"]


@pytest.mark.parametrize("step_impl", ["fused", "two_pass"])
def test_warm_partial_fit_and_update_read_nothing_back(monkeypatch,
                                                       step_impl):
    """The card checks this with ``set_sync_debug_mode("error")``; here no
    value is read to the host on a warm call (the bootstrap may read)."""
    x, _ = _mixture(1200, seed=12)
    sk = StreamingKMeans(KMeansConfig(k=K, step_impl=step_impl),
                         decay=0.9, local_iters=2, init_size=300,
                         device="cpu")
    for lo in (0, 200, 400):                 # buffer, bootstrap, warm
        sk.partial_fit(torch.from_numpy(x[lo:lo + 200]))
    batch = torch.from_numpy(x[600:800])
    assert _count_host_reads(monkeypatch,
                             lambda: sk.partial_fit(batch)) == 0
    assert _count_host_reads(monkeypatch, lambda: sk.update(batch)) == 0
    assert _count_host_reads(monkeypatch, lambda: sk.inertia(batch)) > 0
