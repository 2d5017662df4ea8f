"""The port's two-level router (``repro_torch.index.router``), its route
chooser and plan op, and the routed ``IVFIndex.search(nprobe_c=)``,
against the JAX package's, on the CPU.

Both packages get the same numpy inputs, made from seeds: Gaussian blobs
(spread 2, noise 1, the tie-free corpus of ``tests/test_torch_index.py``)
and the same carried centroids. The two packages' trainings draw from
different RNGs, so a trained router crosses by the bridge (its ``meta()``
and ``state_arrays()``) and both search over one coarse level. The JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions (the tensors lie on the CPU).

Tolerance: the choosers and plan blocks are integers and equal; member
tables are equal; on the tie-free data ids are equal and distances agree
within ``rtol=1e-5`` plus ``atol = 1e-5 * (max ||q||^2 + max ||x||^2)``,
the scale of the expanded form's cancellation (``tests/
test_torch_index.py``); ``q8`` ids are compared where the distance is
finite (the reference's ``+inf`` entries carry other ids).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heuristics as JH
from repro.core.plan import KernelPlanner as JPlanner
from repro.index import IVFIndex as JIVF
from repro.index.router import TwoLevelRouter as JRouter
from repro.index.router import default_router_kind as j_default_router
from repro.index.router import restore_router as j_restore
from repro_torch.core import heuristics as H
from repro_torch.core.plan import KernelPlanner
from repro_torch.index import (FlatRouter, IVFIndex, TwoLevelRouter,
                               default_router_kind, index_from_numpy,
                               index_to_numpy, make_router, recall_at_k,
                               router_from_numpy)
from repro_torch.index.store import _PAD_COORD
from repro_torch.kernels import ops
from tests.test_torch_index import _assert_tie_free, _atol, _blobs

K, D, N, NQ = 64, 16, 3000, 24


def _corpus():
    x, centers = _blobs(1, N, K, D)
    rng = np.random.default_rng(101)
    c0 = centers + 0.5 * rng.standard_normal(centers.shape).astype(np.float32)
    q = x[:NQ] + 0.1 * rng.standard_normal((NQ, D)).astype(np.float32)
    return x, c0.astype(np.float32), q.astype(np.float32)


def _state(router) -> dict:
    return {"meta": router.meta(), "arrays": router.state_arrays()}


def _pair(codec, rescore=None, from_jax=False):
    """One routed index in each package over one coarse level: trained by
    the port (or, ``from_jax``, by the reference) and carried across."""
    x, c0, q = _corpus()
    kw = {} if codec == "fp32" else {"rescore": rescore}
    if from_jax:
        jr = JRouter.train(jnp.asarray(c0), max_iters=4)
        tr = router_from_numpy({"meta": jr.meta(),
                                "arrays": jr.state_arrays()}, device="cpu")
    else:
        tr = TwoLevelRouter.train(torch.from_numpy(c0), max_iters=4,
                                  device="cpu")
        st = _state(tr)
        jr = j_restore(st["meta"], st["arrays"])
    tidx = IVFIndex(c0, 8, device="cpu", codec=codec, router=tr, **kw)
    jidx = JIVF(jnp.asarray(c0), 8, codec=codec, router=jr, **kw)
    tidx.add(x)
    jidx.add(jnp.asarray(x))
    return x, q, jidx, tidx


@pytest.fixture(scope="module", params=[("fp32", None), ("q8", "host"),
                                        ("q8", "device")],
                ids=["fp32", "q8-host", "q8-device"])
def pair(request):
    codec, rescore = request.param
    return _pair(codec, rescore, from_jax=codec == "fp32")


# --- the route chooser and the planner's route op ----------------------------

@pytest.mark.parametrize("k,nprobe", [(4, 4), (15, 8), (16, 8), (64, 8),
                                      (1000, 16), (4096, 64), (65536, 8),
                                      (65536, 65536), (262144, 32)])
def test_route_chooser_matches_jax(k, nprobe):
    for r in (0.5, 0.9, 0.95, 0.99):
        assert H.choose_coarse_nprobe(r) == JH.choose_coarse_nprobe(r)
        assert H.choose_route_params(k, nprobe, recall_target=r) == \
            JH.choose_route_params(k, nprobe, recall_target=r)
    kc, npc = H.choose_route_params(k, nprobe)
    assert H.route_group_cap(k, kc) == JH.route_group_cap(k, kc)
    assert kc & (kc - 1) == 0 or kc == k
    assert 1 <= npc <= min(kc, max(1, nprobe))


@pytest.mark.parametrize("shape,impl", [
    ((8, 65536, 16, 8), "two_level"), ((32, 65536, 128, 16), "two_level"),
    ((256, 65536, 128, 16), "flat"), ((256, 65536, 128, 64), "flat"),
    ((64, 64, 16, 8), "flat"), ((256, 1024, 128, 16), "flat"),
    ((8, 4096, 32, 8), "two_level")])
def test_route_plan_matches_jax(shape, impl):
    """The ``route`` op's ``(K_c, nprobe_c)`` and its byte model's verdict
    equal the reference's (the port's bytes add the ``||c||^2`` strips and
    the store scan's counts, a small term: no shape here lies near the
    crossover)."""
    p = KernelPlanner(H.H100, persist=False).plan("route", shape,
                                                  torch.float32)
    jp = JPlanner(cache_path=None).plan("route", shape, jnp.float32)
    assert p.op == "route" and p.blocks == tuple(jp.blocks)
    assert p.impl == jp.impl == impl
    assert p.smem_bytes <= p.smem_limit
    n, k, d, l = shape
    assert p.hbm_bytes <= H.probe_bytes(n, k, d, l)


def test_probe_bytes_routed_beats_flat_at_large_k():
    n, k, d, l = 8, 65536, 16, 8
    kc, npc = H.choose_route_params(k, l)
    routed = H.probe_bytes_routed(n, k, kc, npc, H.route_group_cap(k, kc),
                                  d, l)
    assert H.probe_bytes(n, k, d, l) / routed >= 4.0


# --- the router's tables -----------------------------------------------------

@pytest.mark.parametrize("k,kc", [(37, 4), (64, 16), (200, 8)])
def test_member_and_group_tables_match_jax(k, kc):
    """From one ``owner``: the member table and ``gcap`` equal the
    reference's; the fine table holds each group's centroids in member
    order and ``_PAD_COORD`` rows past its size."""
    rng = np.random.default_rng(k)
    coarse = rng.normal(size=(kc, 5)).astype(np.float32)
    owner = rng.integers(0, kc, size=k).astype(np.int32)
    cents = rng.normal(size=(k, 5)).astype(np.float32)
    rt = TwoLevelRouter(coarse, owner, device="cpu")
    jr = JRouter(coarse, owner)
    assert rt.gcap == jr.gcap
    assert np.array_equal(rt.members.numpy(), np.asarray(jr.members))
    np.testing.assert_allclose(rt.coarse_sq.numpy(),
                               np.asarray(jr.coarse_sq), rtol=1e-6)
    members = rt.members.numpy()
    assert sorted(members[members < k].tolist()) == list(range(k))
    assert np.all(members[members >= k] == k)
    sizes = np.bincount(owner, minlength=kc)
    assert np.array_equal(rt.group_sizes.numpy(), sizes)
    cpad = np.concatenate([cents, np.full((1, 5), _PAD_COORD, np.float32)])
    assert np.array_equal(rt.view(torch.from_numpy(cents)).numpy(),
                          cpad[members])


def test_effective_nprobe_c_and_fingerprint_match_jax():
    rng = np.random.default_rng(1)
    coarse = rng.normal(size=(16, 4)).astype(np.float32)
    owner = rng.integers(0, 16, size=64).astype(np.int32)
    rt = TwoLevelRouter(coarse, owner, nprobe_c=4, device="cpu")
    jr = JRouter(coarse, owner, nprobe_c=4)
    for nprobe in (1, 8, 17, 63, 64):
        for npc in (None, 1, 2, 16, 999):
            assert rt.effective_nprobe_c(nprobe, npc) == \
                jr.effective_nprobe_c(nprobe, npc)
            assert rt.fingerprint(nprobe, npc) == jr.fingerprint(nprobe, npc)
    assert rt.effective_nprobe_c(64) == 16      # nprobe = K: every group
    assert rt.meta() == jr.meta()


def test_make_router_passthrough_and_errors():
    r = FlatRouter()
    assert make_router(r) is r and r.meta() == {"kind": "flat"}
    assert r.state_arrays() == {} and r.refresh(None) is None
    assert r.fingerprint(8, 3) == () and r.version == 0
    with pytest.raises(ValueError, match="unknown router kind"):
        make_router("banana", np.zeros((8, 4), np.float32), device="cpu")


@pytest.mark.parametrize("env,want", [(None, "flat"), ("flat", "flat"),
                                      ("two_level", "two_level"),
                                      (" Two_Level ", "two_level"),
                                      ("banana", "ValueError")])
def test_repro_router_selects_the_router(monkeypatch, env, want):
    """``REPRO_ROUTER`` as in the reference: the default router of
    ``IVFIndex`` and ``make_router(None)``."""
    if env is None:
        monkeypatch.delenv("REPRO_ROUTER", raising=False)
    else:
        monkeypatch.setenv("REPRO_ROUTER", env)
    c = _blobs(2, 64, 1, 8)[0]
    if want == "ValueError":
        for call in (j_default_router, default_router_kind,
                     lambda: IVFIndex(c, 8, device="cpu")):
            with pytest.raises(ValueError, match="REPRO_ROUTER"):
                call()
        return
    assert default_router_kind() == j_default_router() == want
    idx = IVFIndex(c, 8, device="cpu")
    assert idx.router.kind == want
    assert isinstance(idx.router, TwoLevelRouter if want == "two_level"
                      else FlatRouter)


# --- the routed search against the reference ---------------------------------

def _compare(got, exp, q, x, codec):
    ids, dists = got[0].numpy(), got[1].numpy()
    jids, jdists = np.asarray(exp[0]), np.asarray(exp[1])
    assert ids.dtype == np.int32 and ids.shape == jids.shape
    fin = np.isfinite(jdists)
    assert np.array_equal(np.isfinite(dists), fin)
    if codec == "fp32":
        assert np.array_equal(ids, jids)
    else:
        assert np.array_equal(ids[fin], jids[fin])
    np.testing.assert_allclose(dists[fin], jdists[fin], rtol=1e-5,
                               atol=_atol(q, x))


@pytest.mark.parametrize("nprobe,nprobe_c", [(8, None), (16, 2), (40, 1)],
                         ids=["default-width", "explicit", "leff<nprobe"])
def test_routed_search_matches_jax(pair, nprobe, nprobe_c):
    """Ids equal to the reference's on one carried coarse level, fp32 and
    q8 (device and host rescore), at partial ``nprobe``, at an explicit
    ``nprobe_c`` and where ``nprobe_c * gcap < nprobe`` (the probe list
    ends in sentinel cells)."""
    x, q, jidx, tidx = pair
    _assert_tie_free(q, x)
    _, npc, gcap = tidx.router.fingerprint(nprobe, nprobe_c)
    assert tidx.router.fingerprint(nprobe, nprobe_c) == \
        jidx.router.fingerprint(nprobe, nprobe_c)
    if nprobe_c == 1:
        assert npc * gcap < nprobe
    got = tidx.search(q, topk=10, nprobe=nprobe, nprobe_c=nprobe_c)
    exp = jidx.search(jnp.asarray(q), topk=10, nprobe=nprobe,
                      nprobe_c=nprobe_c)
    _compare(got, exp, q, x, tidx.codec_kind)


def test_sentinel_cells_hold_no_rows(pair):
    """Where a query has fewer candidate cells than ``nprobe`` its probe
    list ends in the sentinel ``K``; the scans read that cell as one with
    no rows: ids are valid or -1, distances finite or ``+inf`` (q8)."""
    x, q, _, tidx = pair
    qt = torch.from_numpy(q)
    head = tidx.plan_search(NQ, 10, 40, 1)
    probe = tidx._probe(qt, 40, 1, head[:2])
    counts = tidx.store.counts_sentinel
    assert counts.shape == (K + 1,) and int(counts[K]) == 0
    if tidx.codec_kind == "q8":
        anchors = tidx.store.anchors_sentinel
        assert anchors.shape == (K + 1, D) and not bool(anchors[K].any())
    assert bool((probe == K).any()) and bool((probe <= K).all())
    ids, dists = tidx.search(q, topk=10, nprobe=40, nprobe_c=1)
    assert bool(((ids >= -1) & (ids < N)).all())
    assert bool((torch.isfinite(dists) | (dists == float("inf"))).all())


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_store_scans_read_the_sentinel_as_an_empty_cell(codec):
    """The store scans with ``K + 1`` counts and probe entries ``K``: the
    same result as over a store with one more cell that holds no rows."""
    rng = np.random.default_rng(5)
    k, cap, d, b, nprobe, width = 6, 16, 16, 5, 4, 16
    counts = torch.from_numpy(rng.integers(0, cap + 1, k).astype(np.int32))
    ext = torch.cat([counts, torch.zeros(1, dtype=torch.int32)])
    probe = torch.from_numpy(rng.integers(0, k + 1, (b, nprobe))
                             .astype(np.int32))
    probe[:, -1] = k
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    if codec == "fp32":
        bk = torch.from_numpy(rng.normal(size=(k, cap, d)).astype(np.float32))
        bk_ext = torch.cat([bk, torch.full((1, cap, d), _PAD_COORD)])
        got = ops.flash_probe_store(q, bk, ext, probe, width=width, l=12,
                                    pad=_PAD_COORD)
        exp = ops.flash_probe_store(q, bk_ext, ext, probe, width=width, l=12,
                                    pad=_PAD_COORD)
    else:
        codes = torch.from_numpy(rng.integers(-127, 128, (k, cap, d))
                                 .astype(np.int8))
        scales = torch.from_numpy(rng.uniform(0.01, 0.1, (k, cap))
                                  .astype(np.float32))
        anchors = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
        got = ops.flash_probe_store_q8(
            q, codes, scales, ext, probe,
            torch.cat([anchors, torch.zeros((1, d))]), width=width, l=12)
        exp = ops.flash_probe_store_q8(
            q, torch.cat([codes, torch.zeros((1, cap, d), dtype=torch.int8)]),
            torch.cat([scales, torch.zeros((1, cap))]), ext, probe,
            torch.cat([anchors, anchors[-1:]]), width=width, l=12)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_full_coverage_routed_equals_flat(codec):
    """``nprobe = K`` covers every group: the routed ids equal the flat
    index's over the same store, and both equal brute force."""
    x, c0, q = _corpus()
    flat = IVFIndex(c0, 8, device="cpu", codec=codec)
    flat.add(x)
    routed = IVFIndex(c0, 8, device="cpu", store=flat.store,
                      router="two_level")
    assert routed.router.effective_nprobe_c(K) == routed.router.coarse_k
    ids_f, d_f = flat.search(q, topk=10, nprobe=K)
    ids_r, d_r = routed.search(q, topk=10, nprobe=K)
    assert torch.equal(ids_f, ids_r)
    np.testing.assert_allclose(d_r.numpy(), d_f.numpy(), rtol=1e-6,
                               atol=_atol(q, x) * 0.1)
    ids_b, _ = flat.search_brute(q, topk=10)
    assert torch.equal(ids_f, ids_b)


def test_routed_recall_and_forced_full_group_coverage():
    """At partial ``nprobe`` the trained width finds the blobs' neighbours;
    ``nprobe_c = K_c`` probes the flat router's cells."""
    x, c0, q = _corpus()
    flat = IVFIndex(c0, 8, device="cpu")
    flat.add(x)
    routed = IVFIndex(c0, 8, device="cpu", store=flat.store,
                      router="two_level")
    ids_b, _ = flat.search_brute(q, topk=10)
    ids_r, _ = routed.search(q, topk=10, nprobe=16)
    assert recall_at_k(ids_r, ids_b) >= 0.9
    ids_f, _ = flat.search(q, topk=10, nprobe=8)
    ids_c, _ = routed.search(q, topk=10, nprobe=8,
                             nprobe_c=routed.router.coarse_k)
    assert torch.equal(ids_c, ids_f)


# --- online mutation, plan keys and the bridge -------------------------------

def test_refresh_reassigns_moved_centroids_and_retrains():
    x, c0, q = _corpus()
    idx = IVFIndex(c0, 8, device="cpu", router="two_level")
    idx.add(x)
    rt = idx.router
    rt.retrain_every = 2
    rng = np.random.default_rng(7)
    idx.add(rng.normal(size=(400, D)).astype(np.float32) * 4.0)
    idx.refresh()
    assert rt.refreshes_since_train == 1
    c = idx.centroids.double().numpy()
    coarse = rt.coarse.double().numpy()
    d2 = ((c[:, None, :] - coarse[None]) ** 2).sum(-1)
    assert np.array_equal(rt.owner, d2.argmin(1))
    cpad = torch.cat([idx.centroids, torch.full((1, D), _PAD_COORD)])
    assert torch.equal(idx._route_view(), cpad[rt.members.long()])
    before = rt.coarse.clone()
    idx.add(x[:200] + 1.0)
    idx.refresh()
    assert rt.refreshes_since_train == 0              # the retrain ran
    assert not torch.equal(rt.coarse, before)
    ids, _ = idx.search(q, topk=5, nprobe=K)
    ids_b, _ = idx.search_brute(q, topk=5)
    assert torch.equal(ids, ids_b)


def test_plan_keys_follow_the_router_fingerprint():
    """``plan_search`` and ``search_geometry`` carry ``(K_c, nprobe_c_eff,
    gcap)``: a re-grouping that moves ``gcap`` to another bucket re-keys
    them (ref. l.1003-1018, l.1066-1130)."""
    x, c0, _ = _corpus()
    flat = IVFIndex(c0, 8, device="cpu")
    flat.add(x)
    idx = IVFIndex(c0, 8, device="cpu", store=flat.store, router="two_level")
    pf, pt = flat.plan_search(8, 10, 8), idx.plan_search(8, 10, 8)
    assert [p.op for p in pf] == ["probe", "scan_store"]
    assert [p.op for p in pt] == ["probe", "scan_store", "scan_store"]
    kc, npc, gcap = idx.router.fingerprint(8)
    assert pt[0].shape[1:] == (kc, D, npc)
    assert pt[1].shape[1:] == (npc, gcap, D, min(8, npc * gcap))
    (kf,) = flat._search_plans
    (kt,) = idx._search_plans
    assert kt == kf[:4] + (kc, npc, gcap)
    geom = idx.search_geometry(10, 8)
    assert geom == flat.search_geometry(10, 8) + (kc, npc, gcap)
    rt = idx.router
    rt.owner = np.where(np.arange(K) < K // 2, 0, rt.owner).astype(np.int32)
    rt._rebuild_members()
    assert rt.gcap != gcap
    assert idx.search_geometry(10, 8) != geom
    idx.plan_search(8, 10, 8)
    assert len(idx._search_plans) == 2
    assert idx.search_geometry(10, 8, nprobe_c=3)[-2] == 3


def test_routed_q8_plan_tuple():
    x, c0, _ = _corpus()
    idx = IVFIndex(c0, 8, device="cpu", codec="q8", router="two_level")
    idx.add(x[:500])
    plans = idx.plan_search(8, 10, 8)
    assert [p.op for p in plans] == ["probe", "scan_store", "scan_q8_store",
                                     "rescore"]


def test_router_crosses_the_bridge_both_ways():
    """``index_to_numpy`` carries the router's meta and arrays,
    ``index_from_numpy`` rebuilds it: the same tables and the same search;
    the reference restores the same router from them."""
    x, c0, q = _corpus()
    idx = IVFIndex(c0, 8, device="cpu", router="two_level")
    idx.add(x)
    state = index_to_numpy(idx)
    back = index_from_numpy(state["centroids"], state["store_arrays"],
                            state["store_meta"], n_total=state["n_total"],
                            stats=state["stats"], pending=state["pending"],
                            router=state["router"], device="cpu")
    assert isinstance(back.router, TwoLevelRouter)
    assert back.router.meta() == idx.router.meta()
    assert torch.equal(back.router.members, idx.router.members)
    assert torch.equal(back._route_view(), idx._route_view())
    for a, b in zip(back.search(q, topk=10, nprobe=8),
                    idx.search(q, topk=10, nprobe=8)):
        assert torch.equal(a, b)
    jr = j_restore(state["router"]["meta"], state["router"]["arrays"])
    assert np.array_equal(np.asarray(jr.members), idx.router.members.numpy())
    flat = index_to_numpy(IVFIndex(c0, 8, device="cpu"))["router"]
    assert flat == {"meta": {"kind": "flat"}, "arrays": {}}
    assert isinstance(router_from_numpy(flat), FlatRouter)
    assert isinstance(router_from_numpy(None), FlatRouter)


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``device=None`` means ``"cuda"`` whatever device the centroids lie
    on, as for ``IVFIndex``: no quiet fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = torch.from_numpy(_corpus()[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoLevelRouter.train(c, max_iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_router("two_level", c)
    assert TwoLevelRouter.train(c, max_iters=1,
                                device="cpu").device.type == "cpu"


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_router_over_other_centroids_scores_the_index_centroids(codec):
    """A router trained over other centroids (``c_old``) and passed to an
    index over ``c_new``: the fine stage reads the index's own centroids,
    so the ids equal the reference's over that router and ``c_new``; and
    an index sharing the router sees the other's refresh re-group it."""
    x, c_new, q = _corpus()
    rng = np.random.default_rng(11)
    c_old = (c_new + 3.0 * rng.standard_normal(c_new.shape)).astype(
        np.float32)
    rt = TwoLevelRouter.train(torch.from_numpy(c_old), max_iters=4,
                              device="cpu")
    st = _state(rt)
    jr = j_restore(st["meta"], st["arrays"])
    kw = {} if codec == "fp32" else {"rescore": "host"}
    tidx = IVFIndex(c_new, 8, device="cpu", codec=codec, router=rt, **kw)
    jidx = JIVF(jnp.asarray(c_new), 8, codec=codec, router=jr, **kw)
    tidx.add(x)
    jidx.add(jnp.asarray(x))
    _assert_tie_free(q, x)
    for nprobe, npc in ((8, None), (16, 2)):
        got = tidx.search(q, topk=10, nprobe=nprobe, nprobe_c=npc)
        exp = jidx.search(jnp.asarray(q), topk=10, nprobe=nprobe,
                          nprobe_c=npc)
        _compare(got, exp, q, x, codec)
    cpad = torch.cat([torch.from_numpy(c_new), torch.full((1, D),
                                                          _PAD_COORD)])
    assert torch.equal(tidx._route_view(), cpad[rt.members.long()])
    # a second index over the same router: another's refresh re-groups it
    other = IVFIndex(c_old, 8, device="cpu", router=rt)
    other.add(x[:500])
    before = rt.version
    other.refresh()
    assert rt.version != before
    cpad = torch.cat([tidx.centroids, torch.full((1, D), _PAD_COORD)])
    assert torch.equal(tidx._route_view(), cpad[rt.members.long()])
