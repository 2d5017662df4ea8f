"""The port's parallel layer on 4 gloo ranks of the CPU, held to the JAX
package's single-device functions on the same numpy inputs.

One group of 4 ranks runs per module (``tests/_torch_parallel_worker.py``,
which imports ``repro_torch`` only): each drives the two-stage assignment,
the N- and K-sharded and the masked Lloyd fits, the compressed fit over a
``pod`` axis, the data-parallel stream and the sharded ``IVFIndex``, and
writes its results to an npz. The tests here compare them with
``repro.kernels.ops.flash_assign``, ``repro.core.make_kmeans_fn``,
``repro.core.streaming`` and ``repro.index.IVFIndex`` on one device, as
the reference's own tests assert sharded = single-device.
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
RTOL, ATOL = 1e-5, 1e-4   # f32 sums reduced in another order


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the 4 ranks, wait for all (a time limit, then kill), load each
    rank's results."""
    out = tmp_path_factory.mktemp("ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(r), str(WORLD), str(out / "store"), str(out)],
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


def _ref_fit(x, c0, monkeypatch, max_iters=50):
    """JAX ``make_kmeans_fn`` from the given initial centroids."""
    import repro.core.kmeans as jkm
    monkeypatch.setattr(jkm, "init_centroids",
                        lambda key, x_, k, init: jnp.asarray(c0))
    st = jkm.make_kmeans_fn(jkm.KMeansConfig(k=W.K, max_iters=max_iters))(
        None, jnp.asarray(x))
    return (np.asarray(st.centroids), np.asarray(st.assignments),
            float(st.inertia), int(st.iteration))


def test_every_rank_holds_the_same_global_results(ranks):
    for r in range(1, WORLD):
        diff = [k for k in ranks[0] if not k.startswith("compressed/")
                and not np.array_equal(ranks[0][k], ranks[r][k])]
        assert not diff, f"rank {r} differs from rank 0 in {diff}"


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_two_stage_assign_matches_flash_assign(ranks, inp, mesh):
    from repro.kernels import ops
    a_ref, m_ref = ops.flash_assign(jnp.asarray(inp["x_assign"]),
                                    jnp.asarray(inp["c_assign"]))
    got = ranks[0]
    assert np.array_equal(got[f"assign/{mesh}/0"], np.asarray(a_ref))
    np.testing.assert_allclose(got[f"assign/{mesh}/1"], np.asarray(m_ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh", ["4x1", "1x4", "2x2"])
def test_sharded_fit_matches_make_kmeans_fn(ranks, inp, mesh, monkeypatch):
    c, a, j, it = _ref_fit(inp["x"], inp["c0"], monkeypatch)
    got = ranks[0]
    assert np.array_equal(got[f"fit/{mesh}/1"], a)
    assert int(got[f"fit/{mesh}/3"]) == it
    np.testing.assert_allclose(got[f"fit/{mesh}/0"], c, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got[f"fit/{mesh}/2"]), j, rtol=1e-4)


@pytest.mark.parametrize("mesh", ["4x1", "1x4", "2x2"])
def test_ragged_masked_fit_matches_make_kmeans_fn(ranks, inp, mesh,
                                                  monkeypatch):
    """1,021 rows padded to a multiple of the data shards: the padding
    stays out of the statistics and the inertia."""
    c, a, j, it = _ref_fit(inp["x_ragged"], inp["c0"], monkeypatch)
    got = ranks[0]
    assert np.array_equal(got[f"masked/{mesh}/1"], a)
    assert int(got[f"masked/{mesh}/3"]) == it
    np.testing.assert_allclose(got[f"masked/{mesh}/0"], c, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got[f"masked/{mesh}/2"]), j, rtol=1e-4)


def test_each_ef_allreduce_sums_the_jax_dequantized_contributions(ranks):
    """On the 2x2x1 ``pod x data x model`` mesh every error-feedback
    exchange over ``pod`` returns, on both ranks of the pair, the sum of
    the two ranks' contributions as the JAX package quantizes and
    dequantizes them."""
    from repro.optim import compression as jc
    n = int(ranks[0]["compressed/ncalls"])
    assert n == 3 * 2 + 4   # 3 iterations x (sums, counts), 4 direct calls
    for dd in range(2):
        pair = [r for r in ranks if int(r["compressed/data"]) == dd]
        assert sorted(int(r["compressed/pod"]) for r in pair) == [0, 1]
        for i in range(n):
            want = 0.0
            for r in sorted(pair, key=lambda r: int(r["compressed/pod"])):
                xe = jnp.asarray(r[f"compressed/call{i}/0"]
                                 + r[f"compressed/call{i}/1"])
                q, s = jc.quantize_int8(xe)
                want = want + np.asarray(jc.dequantize_int8(q, s, xe.shape))
            for r in pair:
                assert np.array_equal(r[f"compressed/call{i}/2"], want), i


def test_compressed_fit_feeds_the_error_back(ranks):
    """The compressed fit over ``pod``: 3 iterations, each exchanging the
    sums then the counts. The first exchange of each is within the int8
    rounding of the exact sum (half a scale, absmax / 127, a rank), and
    every later one carries as its residual the rank's previous input less
    its JAX-dequantized codes."""
    from repro.optim import compression as jc
    for r in ranks:
        assert int(r["compressed/fit/3"]) == 3
        assert np.isfinite(r["compressed/fit/0"]).all()
        for i in (0, 1):   # iteration 1: no residual yet
            assert not r[f"compressed/call{i}/1"].any()
    for dd in range(2):
        pair = [r for r in ranks if int(r["compressed/data"]) == dd]
        for i in (0, 1):
            xs = [r[f"compressed/call{i}/0"] for r in pair]
            slack = sum(np.abs(x).max() / 127 / 2 for x in xs)
            exact = xs[0] + xs[1]
            for r in pair:
                got = r[f"compressed/call{i}/2"]
                assert np.abs(got - exact).max() <= slack * (1 + 1e-6)
        for r in pair:
            for i in range(2, 6):   # sums feed sums, counts feed counts
                xe = jnp.asarray(r[f"compressed/call{i - 2}/0"]
                                 + r[f"compressed/call{i - 2}/1"])
                q, sc = jc.quantize_int8(xe)
                want = np.asarray(xe - jc.dequantize_int8(q, sc, xe.shape))
                np.testing.assert_allclose(r[f"compressed/call{i}/1"], want,
                                           rtol=0, atol=1e-6 * float(
                                               np.abs(xe).max()))


def test_partial_fit_step_matches_the_reference(ranks, inp):
    from repro.core import KMeansConfig
    from repro.core.streaming import SufficientStats, partial_fit_step
    x = jnp.asarray(inp["stream"][1])
    z = SufficientStats.zero(W.K, W.D)
    c, st, a, bj = partial_fit_step(x, jnp.asarray(inp["c0"]), z,
                                    cfg=KMeansConfig(k=W.K, max_iters=50),
                                    decay=0.9, local_iters=2)
    got = ranks[0]
    assert np.array_equal(got["partial/4"], np.asarray(a))
    for i, want in enumerate((c, st.sums, st.counts, st.inertia, None, bj)):
        if want is not None:
            np.testing.assert_allclose(got[f"partial/{i}"], np.asarray(want),
                                       rtol=RTOL, atol=ATOL)


def test_streaming_kmeans_over_a_ragged_stream(ranks, inp):
    from repro.core import KMeansConfig, StreamingKMeans
    from repro.core.streaming import SufficientStats
    sk = StreamingKMeans(KMeansConfig(k=W.K, max_iters=50), decay=0.9)
    sk.centroids = jnp.asarray(inp["c0"])
    sk.stats = SufficientStats.zero(W.K, W.D)
    got = ranks[0]
    for i, b in enumerate(inp["stream"]):
        sk.partial_fit(jnp.asarray(b))
        for j, want in enumerate((sk.centroids, *sk.stats)):
            np.testing.assert_allclose(got[f"stream/{i}/{j}"],
                                       np.asarray(want), rtol=RTOL,
                                       atol=ATOL)
    a = sk.update(jnp.asarray(inp["stream"][2]))
    assert np.array_equal(got["stream/update/0"], np.asarray(a))
    np.testing.assert_allclose(got["stream/update/1"],
                               np.asarray(sk.centroids), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def ref_index(inp):
    """The JAX single-device index of the worker's sharded one, with its
    results before and after an add and a refresh."""
    from repro.index import IVFIndex
    idx = IVFIndex(jnp.asarray(inp["centers"]), capacity=128)
    out = {"add": np.asarray(idx.add(jnp.asarray(inp["x"])))}
    q = jnp.asarray(inp["q"])
    for npb in (4, W.K):
        out[f"search{npb}"] = idx.search(q, topk=10, nprobe=npb)
    out["ragged"] = idx.search(jnp.asarray(inp["q_ragged"]), topk=10,
                               nprobe=4)
    out["add2"] = np.asarray(idx.add(jnp.asarray(inp["x2"])))
    idx.refresh()
    out["refreshed"] = (idx.centroids, idx.counts)
    for npb in (4, W.K):
        out[f"after{npb}"] = idx.search(q, topk=10, nprobe=npb)
    out["brute"] = idx.search_brute(q, topk=10)
    out["lists"] = idx.posting_lists()
    return out


@pytest.mark.parametrize("case", ["search4", "search16", "ragged", "after4",
                                  "after16", "brute"])
def test_sharded_index_search_matches_the_reference(ranks, ref_index, case):
    """k 16, d 8, n 1,024 on a 2x2 mesh (2 data x 2 cell shards): nprobe 4
    and K, a ragged batch of 63, then again after an add of 257 rows and a
    refresh; ids equal, distances within f32 rounding."""
    ids, dists = ref_index[case]
    got = ranks[0]
    assert np.array_equal(got[f"ivf/{case}/0"], np.asarray(ids))
    np.testing.assert_allclose(got[f"ivf/{case}/1"], np.asarray(dists),
                               rtol=RTOL, atol=1e-3)


def test_sharded_index_state_matches_the_reference(ranks, ref_index):
    got = ranks[0]
    assert np.array_equal(got["ivf/add/0"], ref_index["add"])
    assert np.array_equal(got["ivf/add2/0"], ref_index["add2"])
    c, counts = ref_index["refreshed"]
    np.testing.assert_allclose(got["ivf/refreshed/0"], np.asarray(c),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(got["ivf/refreshed/1"], np.asarray(counts))
    for i in range(2):
        assert np.array_equal(got[f"ivf/lists/{i}"],
                              np.asarray(ref_index["lists"][i]))
    from repro.core.parallel import search_collective_bytes_model
    assert int(got["ivf/bytes/0"]) == search_collective_bytes_model(
        64, 4, 10, W.K, 2)


def test_result_merge_breaks_ties_by_probe_order(ranks, inp):
    """The reference's exact cross-shard tie (tests/distributed/
    test_parallel.py:372): the cell probed first is owned by the higher
    shard, and its point must win, as on one device."""
    from repro.index import IVFIndex
    ref = IVFIndex(jnp.asarray(inp["tie_centers"]), capacity=8)
    ref.add(jnp.asarray(inp["tie_pts"]))
    ids, dists = ref.search(jnp.asarray(inp["tie_q"]), topk=1, nprobe=2)
    assert int(ids[0, 0]) == 1
    assert np.array_equal(ranks[0]["tie/0"], np.asarray(ids))
    np.testing.assert_allclose(ranks[0]["tie/1"], np.asarray(dists))


def _ref_build(x, c0, monkeypatch, q):
    """The JAX fit of ``build`` from the port's own initial centroids (3
    iterations, tol 0, as ``build`` runs), and a JAX index over the
    result: ``(centroids, ids of q at nprobe 4)``."""
    from repro.index import IVFIndex
    c, _, _, _ = _ref_fit(x, c0, monkeypatch, max_iters=3)
    ref = IVFIndex(jnp.asarray(c), capacity=128)
    ref.add(jnp.asarray(x))
    return c, np.asarray(ref.search(jnp.asarray(q), topk=10, nprobe=4)[0])


def _port_c0(x):
    """``build``'s initial centroids: kmeans++ from a generator seeded 0."""
    import torch
    from repro_torch.core.init import init_centroids
    return init_centroids(torch.from_numpy(x), W.K, "kmeans++",
                          generator=torch.Generator().manual_seed(0)).numpy()


def test_sharded_build_matches_the_single_device_build(ranks, inp,
                                                       monkeypatch):
    """``build(pctx=)`` trains to the centroids of JAX's ``make_kmeans_fn``
    from the same initial centroids (the sums add in another order), its
    search gives the ids of a JAX index over those centroids, and it serves
    (recall against its own brute force). The port's one-device build
    agrees too."""
    from repro_torch.index import IVFIndex, recall_at_k
    c, ids = _ref_build(inp["x"], _port_c0(inp["x"]), monkeypatch, inp["q"])
    got = ranks[0]
    np.testing.assert_allclose(got["build/0"], c, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got["build/1"], ids)
    assert recall_at_k(got["build/1"], got["build/3"]) >= 0.9
    single = IVFIndex.build(inp["x"], k=W.K, max_iters=3, device="cpu")
    np.testing.assert_allclose(got["build/0"], single.centroids.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_bf16_and_chunked_builds_on_the_mesh_match_one_device(
        ranks, inp, monkeypatch):
    """A bf16 sharded index against the JAX index over bf16 centres (its
    dtype follows the centroids): ids and distances bit for bit. And
    ``build(chunk_size=, pctx=)`` (one-device ``ChunkedKMeans`` training
    from centroids drawn on the first chunk, then the sharded inversion)
    against JAX's ``make_kmeans_fn`` from those centroids and a JAX index
    over the result. The port's one-device indexes agree too."""
    import torch
    from repro.index import IVFIndex as JIVF
    from repro_torch.index import IVFIndex
    got = ranks[0]
    ref = JIVF(jnp.asarray(inp["centers"]).astype(jnp.bfloat16),
               capacity=128)
    ref.add(jnp.asarray(inp["x"]).astype(jnp.bfloat16))
    ids, dists = ref.search(jnp.asarray(inp["q"]).astype(jnp.bfloat16),
                            topk=10, nprobe=4)
    assert np.array_equal(got["bf16/0"], np.asarray(ids))
    assert np.array_equal(got["bf16/1"], np.asarray(dists, np.float32))
    c, ids = _ref_build(inp["x"], _port_c0(inp["x"][:256]), monkeypatch,
                        inp["q"])
    np.testing.assert_allclose(got["chunked/0"], c, rtol=RTOL, atol=ATOL)
    assert np.array_equal(got["chunked/1"], ids)
    q, x = torch.from_numpy(inp["q"]), torch.from_numpy(inp["x"])
    half = IVFIndex(torch.from_numpy(inp["centers"]).to(torch.bfloat16), 128,
                    device="cpu")
    half.add(x.to(torch.bfloat16))
    assert np.array_equal(got["bf16/0"], half.search(
        q.to(torch.bfloat16), topk=10, nprobe=4)[0].numpy())
    one = IVFIndex.build(inp["x"], k=W.K, max_iters=3, chunk_size=256,
                         device="cpu")
    np.testing.assert_allclose(got["chunked/0"], one.centroids.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_a_data_only_mesh_shards_the_add_and_keeps_the_store_whole(
        ranks, ref_index, inp):
    got = ranks[0]
    assert np.array_equal(got["data_only/add/0"], ref_index["add"])
    assert int(got["data_only/add/1"]) == W.K
    from repro.index import IVFIndex
    ref = IVFIndex(jnp.asarray(inp["centers"]), capacity=128)
    ref.add(jnp.asarray(inp["x"]))
    ids, _ = ref.search(jnp.asarray(inp["q"]), topk=10, nprobe=4)
    assert np.array_equal(got["data_only/0"], np.asarray(ids))
