"""The port's out-of-core driver (``ChunkedKMeans``) and the out-of-core
``IVFIndex.build(chunk_size=)`` against the JAX package's and against the
port's in-core Lloyd step, on the CPU.

Both packages get the same numpy inputs: a well-separated Gaussian mixture
near the origin (tie-free, so ids are equal) and the same starting
centroids. The JAX side runs its Pallas kernels in interpret mode, the
port its kernels' plain versions (no streams or pinned memory on the CPU:
the plain path slices and steps). Tolerance (f32): ids equal; centroids
and inertia within ``rtol=atol=1e-5`` (the chunks' statistics merge in
another order than one batch's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.index import IVFIndex as JIVF
from repro_torch.core import (ChunkedKMeans, ChunkedStats, KMeans,
                              KMeansConfig, lloyd_step)
from repro_torch.index import IVFIndex
from tests.test_torch_index import _assert_search_equal, _blobs

K, D, N = 7, 12, 1000
TOL = dict(rtol=1e-5, atol=1e-5)


def _mixture(n=N, seed=0, k=K, d=D, spread=3.0, noise=0.4):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((k, d)) * spread).astype(np.float32)
    x = centers[rng.integers(0, k, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * noise
    c0 = centers + 0.3 * rng.standard_normal(centers.shape)
    return x.astype(np.float32), c0.astype(np.float32)


def _factory(x, size, as_tensor=False):
    def chunks():
        for lo in range(0, x.shape[0], size):
            part = x[lo:lo + size]
            yield torch.from_numpy(part.copy()) if as_tensor else part
    return chunks


@pytest.mark.parametrize("sample_every", [1, 8])
def test_sample_every_is_taken_and_ignored(sample_every):
    """The reference's signature ``ChunkedKMeans(cfg, chunk_size,
    sample_every)`` builds the port's driver too (it times every warm chunk
    with CUDA events, so the sampling rate has nothing to set), and the
    iteration equals the reference's and the port's without it."""
    x, c0 = _mixture()
    ck = ChunkedKMeans(KMeansConfig(k=K, max_iters=1), 250, sample_every,
                       device="cpu")
    c1, j1 = ck.iterate(x, torch.from_numpy(c0))
    c2, j2 = ChunkedKMeans(KMeansConfig(k=K, max_iters=1), 250,
                           device="cpu").iterate(x, torch.from_numpy(c0))
    assert torch.equal(c1, c2) and torch.equal(j1, j2)
    jck = J.ChunkedKMeans(J.KMeansConfig(k=K, max_iters=1), 250,
                          sample_every)
    jc, jj = jck.iterate(x, jnp.asarray(c0))
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(j1), float(jj), **TOL)


@pytest.mark.parametrize("source", ["array", "tensor", "factory"])
@pytest.mark.parametrize("chunk", [100, 250, 256, 1000, 5000])
def test_iterate_matches_in_core_and_jax(chunk, source):
    """Chunk sizes that divide N and ragged ones, one chunk, more than N."""
    x, c0 = _mixture()
    cfg = KMeansConfig(k=K, max_iters=1)
    data = {"array": x, "tensor": torch.from_numpy(x),
            "factory": _factory(x, chunk)}[source]
    ck = ChunkedKMeans(cfg, chunk_size=chunk, device="cpu")
    ids = torch.full((N,), -1, dtype=torch.int32)
    c1, j1 = ck.iterate(data, torch.from_numpy(c0), assignments=ids)
    c_in, a_in, j_in = lloyd_step(torch.from_numpy(x), torch.from_numpy(c0),
                                  cfg)
    np.testing.assert_array_equal(ids.numpy(), a_in.numpy())
    np.testing.assert_allclose(c1.numpy(), c_in.numpy(), **TOL)
    np.testing.assert_allclose(float(j1), float(j_in), rtol=1e-5)
    np.testing.assert_array_equal(ck.last_stats.counts.numpy(),
                                  np.bincount(a_in.numpy(), minlength=K))
    jck = J.ChunkedKMeans(J.KMeansConfig(k=K, max_iters=1), chunk_size=chunk)
    jc1, jj1 = jck.iterate(x if source != "factory" else _factory(x, chunk),
                           jnp.asarray(c0))
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc1), **TOL)
    np.testing.assert_allclose(float(j1), float(jj1), rtol=1e-5)
    n_chunks = -(-N // min(chunk, N))
    assert ck.stats.chunks == n_chunks
    # warm chunks: every one but the first of each row count
    assert ck.stats.sampled_chunks == n_chunks - len({
        min(chunk, N - lo) for lo in range(0, N, min(chunk, N))})


def test_fit_tol_stops_where_the_reference_does():
    x, c0 = _mixture(1500, seed=1, k=4, d=6)
    cfg = KMeansConfig(k=4, max_iters=50, tol=1e-4)
    ck = ChunkedKMeans(cfg, chunk_size=400, device="cpu")
    c, j = ck.fit(x, torch.from_numpy(c0))
    jck = J.ChunkedKMeans(J.KMeansConfig(k=4, max_iters=50, tol=1e-4),
                          chunk_size=400)
    jc, jj = jck.fit(x, jnp.asarray(c0))
    assert 1 <= ck.iters_run == jck.iters_run < 50
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(j), float(jj), rtol=1e-5)
    st = KMeans(cfg, device="cpu").fit(torch.from_numpy(x),
                                       c0=torch.from_numpy(c0))
    assert int(st.iteration) == ck.iters_run
    np.testing.assert_allclose(c.numpy(), st.centroids.numpy(), **TOL)


@pytest.mark.parametrize("iters", [None, 2])
def test_fit_tol_zero_runs_every_iteration(iters):
    """tol=0 keeps going on data with no exact fixed point in reach."""
    x = np.random.default_rng(2).standard_normal((500, 4)).astype(np.float32)
    c0 = x[:3].copy()
    ck = ChunkedKMeans(KMeansConfig(k=3, max_iters=3), chunk_size=200,
                       device="cpu")
    ck.fit(_factory(x, 200, as_tensor=True), torch.from_numpy(c0),
           iters=iters)
    assert ck.iters_run == (3 if iters is None else iters)
    assert ck.stats.chunks == 3 * ck.iters_run


def test_telemetry_and_chunk_contract(monkeypatch):
    x, c0 = _mixture(600, seed=3)
    ck = ChunkedKMeans(KMeansConfig(k=K), chunk_size=200, device="cpu")
    ck.iterate(x, torch.from_numpy(c0))
    st = ck.stats
    assert isinstance(st, ChunkedStats) and st.chunks == 3
    assert st.sampled_chunks == 2 and st.compute_seconds > 0
    # no copy on the CPU: the copy and dispatch fields stay 0
    assert st.h2d_seconds == st.staging_seconds == 0.0
    assert st.dispatch_h2d_seconds == st.dispatch_compute_seconds == 0.0
    with pytest.raises(ValueError, match="at most chunk_size=200"):
        ck.iterate(_factory(x, 300), torch.from_numpy(c0))
    with pytest.raises(ValueError, match="chunk_size"):
        ChunkedKMeans(KMeansConfig(k=K), chunk_size=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChunkedKMeans(KMeansConfig(k=K), chunk_size=200)


def test_planner_is_a_cache_hit_after_each_buckets_first_chunk():
    from repro_torch.core import KernelPlanner
    x, c0 = _mixture(1000, seed=4)
    planner = KernelPlanner(device="cpu", persist=False)
    ck = ChunkedKMeans(KMeansConfig(k=K, planner=planner), chunk_size=300,
                       device="cpu")
    ck.iterate(x, torch.from_numpy(c0))       # buckets 512 and 128 (tail)
    calls = planner.counters()["chooser_calls"]
    assert calls == 2
    ck.iterate(x, torch.from_numpy(c0))
    assert planner.counters()["chooser_calls"] == calls


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_chunked_ivf_build_matches_jax(codec, monkeypatch):
    """Both builds start from one ``c0`` (each package's ``init_centroids``
    patched here), train out of core and invert the same chunk stream:
    centroids within tolerance, the same ids in each posting list, the same
    search ids (the corpus's cell margins and the queries' neighbours are
    tie-free)."""
    import repro.index.ivf as jivf_mod
    import repro_torch.index.ivf as tivf_mod
    k, d, n = 16, 16, 2000
    x, centers = _blobs(1, n, k, d)
    c0 = (centers + np.random.default_rng(101).standard_normal(
        centers.shape).astype(np.float32)).astype(np.float32)
    monkeypatch.setattr(jivf_mod, "init_centroids",
                        lambda key, first, kk, init: jnp.asarray(c0))
    monkeypatch.setattr(tivf_mod, "init_centroids",
                        lambda first, kk, init, generator:
                        torch.from_numpy(c0))
    kw = dict(max_iters=4, chunk_size=512, codec=codec)
    if codec == "q8":
        kw["rescore"] = "host"
    jidx = JIVF.build(x, k, **kw)
    tidx = IVFIndex.build(x, k, device="cpu", **kw)
    jc = np.asarray(jidx.centroids)
    np.testing.assert_allclose(tidx.centroids.numpy(), jc, **TOL)
    dist = ((x[:, None, :].astype(np.float64) - jc[None]) ** 2).sum(-1)
    two = np.sort(dist, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() > 1e-3, "pick another seed"
    ids, off = (t.numpy() for t in tidx.posting_lists())
    jids, joff = (np.asarray(t) for t in jidx.posting_lists())
    np.testing.assert_array_equal(off, joff)
    for cell in range(k):
        np.testing.assert_array_equal(np.sort(ids[off[cell]:off[cell + 1]]),
                                      np.sort(jids[joff[cell]:joff[cell + 1]]))
    assert len(tidx) == len(jidx) == n
    rng = np.random.default_rng(3)   # a seed whose queries are tie-free
    q = (centers[rng.integers(0, k, 32)]
         + rng.standard_normal((32, d))).astype(np.float32)
    _assert_search_equal(tidx.search(q, topk=5, nprobe=k),
                         jidx.search(jnp.asarray(q), topk=5, nprobe=k), q, x)


def _fake_cuda(monkeypatch, log):
    """Streams and events that log, and pinned memory that is plain host
    memory: the card's double-buffer protocol run on the CPU."""
    import contextlib

    from repro_torch.core import chunked

    class Event:
        made = 0

        def __init__(self, enable_timing=False):
            Event.made += 1
            self.id = Event.made

        def record(self, stream=None):
            log.append(("record", stream.name, self.id))

        def synchronize(self):
            log.append(("host_wait", self.id))

        def elapsed_time(self, other):
            return 1.0

    class Stream:
        def __init__(self, name):
            self.name = name

        def wait_event(self, ev):
            log.append(("wait", self.name, ev.id))

    comp, copy = Stream("compute"), Stream("copy")

    @contextlib.contextmanager
    def on(stream):
        log.append(("on", stream.name))
        yield

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev: copy)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: comp)
    monkeypatch.setattr(torch.cuda, "stream", on)
    monkeypatch.setattr(chunked, "_pinned_empty",
                        lambda shape, dtype: torch.empty(shape, dtype=dtype))
    return Event


@pytest.mark.parametrize("pinned", [False, True])
def test_double_buffer_protocol(monkeypatch, pinned):
    """The card's pipeline, its streams and events logged: chunk j's copy
    into slot j % 2 waits for the launches of chunk j - 2 (which read that
    slot), its launches wait for its copy, and the host waits for chunk
    j - 2's copy before it pulls chunk j from the source or refills its
    pinned buffer. The statistics are the plain path's."""
    log = []
    event = _fake_cuda(monkeypatch, log)
    if pinned:
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    x, c0 = _mixture(1000, seed=5)
    ck = ChunkedKMeans(KMeansConfig(k=K), chunk_size=150, device="cpu")
    step, pulls = ck._step, []

    def logged_step(*a):
        log.append(("step", len([e for e in log if e[0] == "step"])))
        return step(*a)

    def source():
        for j, lo in enumerate(range(0, 1000, 150)):
            log.append(("pull", j))
            yield x[lo:lo + 150]

    ck._step = logged_step
    event.made = 0
    ids = torch.empty(1000, dtype=torch.int32)
    stats, timed = ck._iterate_cuda(iter(source()), torch.from_numpy(c0),
                                    ids)
    n_chunks = 7
    at = {e: i for i, e in enumerate(log)}
    for j in range(n_chunks):
        h0, copied, k0, consumed = (4 * j + 1, 4 * j + 2, 4 * j + 3,
                                    4 * j + 4)
        # the copy is issued on the copy stream, between its two events
        assert ("on", "copy") in log[at[("record", "copy", h0)]:
                                     at[("record", "copy", copied)]]
        assert at[("wait", "compute", copied)] < at[("step", j)]
        assert at[("record", "compute", k0)] < at[("step", j)] \
            < at[("record", "compute", consumed)]
        if j >= 2:
            prev_copied, prev_consumed = 4 * (j - 2) + 2, 4 * (j - 2) + 4
            assert at[("wait", "copy", prev_consumed)] < \
                at[("record", "copy", h0)]
            assert at[("host_wait", prev_copied)] < at[("pull", j)]
        else:   # slots not used yet: nothing to wait for
            assert not any(e[:2] == ("wait", "copy")
                           for e in log[:at[("record", "copy", h0)]])
    assert len(timed) == n_chunks - 2            # 150-row chunks, then 100
    assert (ck.stats.staging_seconds == 0.0) == pinned
    assert (ck._pinned is None) == pinned
    plain = ChunkedKMeans(KMeansConfig(k=K), chunk_size=150, device="cpu")
    ids_p = torch.empty(1000, dtype=torch.int32)
    plain.iterate(x, torch.from_numpy(c0), assignments=ids_p)
    np.testing.assert_array_equal(ids.numpy(), ids_p.numpy())
    for got, want in zip(stats, plain.last_stats):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
