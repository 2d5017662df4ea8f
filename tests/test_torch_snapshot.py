"""Snapshots, checkpoints and WAL records crossing between the JAX package
and the port (``repro_torch.reliability``, ``repro_torch.checkpoint``), on
the CPU.

Both packages get the same numpy inputs: a corpus of Gaussian blobs made
from a seed, the same starting centroids (blob centres plus noise), one
``add`` of the corpus. A snapshot written by one package is loaded by the
other: every store array (``state_arrays``) must be equal, bit for bit,
and searches over the loaded index must return the writer's ids.

Tolerance: ids exact on tie-free queries (the 16 nearest exact distances
of every query more than ``1e-6 * (max ||q||^2 + max ||x||^2)`` apart,
checked); distances within ``rtol=1e-5`` plus ``atol = 1e-5 * (max ||q||^2
+ max ||x||^2)``, the tolerance ``tests/test_torch_index.py`` states (the
packages sum ``||x||^2 - 2 q.x`` in different orders). Within one package
a round trip is bit for bit.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.index import IVFIndex as JIVF
from repro.index.router import TwoLevelRouter as JTwoLevel
from repro.reliability import snapshot as jsnap
from repro.reliability.wal import AddLog as JAddLog
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _treedef
from repro_torch.index import IVFIndex, index_to_numpy
from repro_torch.index import router_from_numpy
from repro_torch.reliability import (AddLog, clone_index,
                                     latest_snapshot_seqno, load_index,
                                     read_manifest, save_index)
from repro_torch.reliability import snapshot as tsnap

K, D, N, NQ = 16, 16, 1500, 40


def _blobs(seed, n, k=K, d=D, spread=2.0, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32) * noise
    return x.astype(np.float32), centers


def _atol(q, x):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((x * x).sum(-1).max()))


def _assert_tie_free(q, x, depth=16):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gap = np.diff(np.sort(dist, axis=1)[:, :depth], axis=1).min()
    assert gap > 0.1 * _atol(q, x), f"near-tie {gap:.3g}: pick another seed"


@pytest.fixture(scope="module")
def data():
    x, centers = _blobs(36, N)
    c0 = centers + np.random.default_rng(136).standard_normal(
        centers.shape).astype(np.float32) * 0.5
    q = x[1::7][:NQ]
    _assert_tie_free(q, x)
    return x, c0, q


KINDS = {"padded": {}, "paged": {"store": "paged", "page_size": 16},
         "q8": {"codec": "q8"},
         "q8-paged": {"codec": "q8", "store": "paged", "page_size": 16},
         "two_level": {"router": "two_level"}}


def _pair(kind, data):
    """The same index in both packages. The two-level router is trained
    by the JAX package and carried into the port by its state."""
    x, c0, _ = data
    kw = dict(KINDS[kind])
    if kw.pop("router", None):
        jr = JTwoLevel.train(jnp.asarray(c0), coarse_k=4, nprobe_c=2,
                             max_iters=4)
        kw["router"] = jr
    jidx = JIVF(jnp.asarray(c0), 8, **kw)
    if "router" in kw:
        kw["router"] = router_from_numpy(
            {"meta": jr.meta(), "arrays": jr.state_arrays()}, device="cpu")
    tidx = IVFIndex(c0, 8, device="cpu", **kw)
    jidx.add(jnp.asarray(x))
    tidx.add(x)
    return jidx, tidx


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request, data):
    return request.param, *_pair(request.param, data)


def _state_equal(got: dict, exp: dict):
    assert sorted(got) == sorted(exp)
    for key in exp:
        a, b = np.asarray(got[key]), np.asarray(exp[key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def _search_equal(tidx, jidx, q, x):
    got = tidx.search(q, topk=10, nprobe=4)
    exp = jidx.search(jnp.asarray(q), topk=10, nprobe=4)
    assert np.array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(exp[1]),
                               rtol=1e-5, atol=_atol(q, x))


# --- IVF snapshots in both directions ---------------------------------------

def test_jax_snapshot_loads_in_the_port(pair, data, tmp_path):
    kind, jidx, _ = pair
    x, _, q = data
    jidx.save(str(tmp_path), seqno=4, extra={"refresh_count": 2})
    tidx = IVFIndex.load(str(tmp_path), device="cpu")
    _state_equal(tidx.store.state_arrays(), jidx.store.state_arrays())
    _state_equal(tidx.router.state_arrays(), jidx.router.state_arrays())
    assert tidx.store.kind == jidx.store.kind
    assert tidx.codec_kind == jidx.codec_kind
    assert tidx.router.kind == jidx.router.kind
    assert tidx.n_total == jidx.n_total
    assert np.array_equal(tidx.centroids.numpy(), np.asarray(jidx.centroids))
    for a, b in zip(index_to_numpy(tidx)["stats"], jidx.stats):
        assert np.array_equal(a, np.asarray(b))
    if kind.startswith("q8"):   # the cache re-warmed from the reservoir
        assert tidx.store.cache is not None
        assert tidx.store.cache.inserted == jidx.n_total
    _search_equal(tidx, jidx, q, x)


def test_port_snapshot_loads_in_jax(pair, data, tmp_path):
    kind, jidx, tidx = pair
    x, _, q = data
    tidx.save(str(tmp_path), seqno=4, extra={"refresh_count": 2})
    back = JIVF.load(str(tmp_path))
    _state_equal(tidx.store.state_arrays(), back.store.state_arrays())
    _state_equal(tidx.router.state_arrays(), back.router.state_arrays())
    assert back.store.kind == tidx.store.kind
    assert back.router.kind == tidx.router.kind
    assert back.n_total == tidx.n_total
    assert back._search_plans == {}
    _search_equal(tidx, back, q, x)


def test_port_manifest_equals_the_reference(pair, tmp_path):
    """Same state, same manifest: version, seqno, scalars, store and
    router meta, every array's shape and dtype, extra; only
    ``search_plans`` differs (the port writes none)."""
    kind, jidx, tidx = pair
    jidx.plan_search(8, 10, 4)   # a JAX plan to record
    tidx.save(str(tmp_path / "t"), seqno=7, extra={"refresh_count": 3})
    jidx.save(str(tmp_path / "j"), seqno=7, extra={"refresh_count": 3})
    mt = read_manifest(str(tmp_path / "t"))
    mj = jsnap.read_manifest(str(tmp_path / "j"))
    assert mt.pop("search_plans") == [] and mj.pop("search_plans")
    assert mt == mj
    assert mt["version"] == tsnap.SNAPSHOT_VERSION == jsnap.SNAPSHOT_VERSION
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_round_trip_is_bit_for_bit(pair, data, tmp_path):
    kind, _, tidx = pair
    _, _, q = data
    path = save_index(tidx, str(tmp_path), seqno=2)
    assert os.path.basename(path) == "index_00000002.npz"
    assert latest_snapshot_seqno(str(tmp_path)) == 2
    back = load_index(str(tmp_path), device="cpu")
    _state_equal(back.store.state_arrays(), tidx.store.state_arrays())
    for a, b in zip(index_to_numpy(back)["pending"],
                    index_to_numpy(tidx)["pending"]):
        assert np.array_equal(a, b)
    got, exp = back.search(q, topk=10, nprobe=4), tidx.search(q, topk=10,
                                                               nprobe=4)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


# --- plans never cross ---------------------------------------------------------

def test_plan_caches_do_not_cross(data, tmp_path):
    """A JAX snapshot carries TPU tile plans: the port loads it with an
    empty plan cache and plans its own; a port snapshot carries none, and
    the JAX package plans its own."""
    x, _, q = data
    jidx, tidx = _pair("padded", data)
    jidx.plan_search(NQ, 10, 4)
    jidx.save(str(tmp_path / "j"))
    assert jsnap.read_manifest(str(tmp_path / "j"))["search_plans"]
    loaded = IVFIndex.load(str(tmp_path / "j"), device="cpu")
    assert loaded._search_plans == {}
    _search_equal(loaded, jidx, q, x)
    assert loaded._search_plans and all(
        type(p).__name__ == "KernelPlan"
        for plans in loaded._search_plans.values() for p in plans)
    tidx.plan_search(NQ, 10, 4)
    tidx.save(str(tmp_path / "t"))
    back = JIVF.load(str(tmp_path / "t"))
    assert back._search_plans == {}
    _search_equal(tidx, back, q, x)


# --- older manifests ---------------------------------------------------------

def _downgrade(directory, version):
    """Rewrite a v5 manifest as the given older version wrote it."""
    path = os.path.join(directory, "index_manifest.json")
    with open(path) as f:
        m = json.load(f)
    m["version"] = version
    if version <= 4:
        m["store"].pop("rescore_cache", None)
    if version <= 3:
        m.pop("router", None)
    if version <= 2:
        for key in ("codec", "reservoir", "rescore_bytes"):
            m["store"].pop(key, None)
    if version <= 1:
        m.pop("store")
    with open(path, "w") as f:
        json.dump(m, f)


@pytest.mark.parametrize("version,kind", [(4, "q8"), (3, "padded"),
                                          (3, "two_level"), (2, "paged"),
                                          (1, "padded")])
def test_older_manifests_restore_as_the_reference_restores_them(
        version, kind, data, tmp_path):
    x, _, q = data
    jidx, _ = _pair(kind, data)
    jidx.save(str(tmp_path))
    _downgrade(str(tmp_path), version)
    exp = JIVF.load(str(tmp_path))
    got = IVFIndex.load(str(tmp_path), device="cpu")
    assert got.store.kind == exp.store.kind
    assert got.codec_kind == exp.codec_kind
    assert got.router.kind == exp.router.kind   # v3: flat, the key is gone
    assert (getattr(got.store, "cache", None) is None) == \
        (getattr(exp.store, "cache", None) is None)
    _state_equal(got.store.state_arrays(), exp.store.state_arrays())
    _search_equal(got, exp, q, x)


def test_an_older_seqno_restores_from_its_shapes(data, tmp_path):
    """A snapshot older than the manifest: scalars re-derived from the
    arrays (``infer_store_meta``), in both packages alike."""
    x, _, q = data
    for kind in ("padded", "paged"):
        jidx, _ = _pair(kind, data)
        d = str(tmp_path / kind)
        jidx.save(d, seqno=1)
        jidx.add(jnp.asarray(x[:64]))
        jidx.save(d, seqno=2)
        exp = JIVF.load(d, seqno=1)
        got = IVFIndex.load(d, seqno=1, device="cpu")
        assert got.n_total == exp.n_total == N
        assert got.store.meta() == exp.store.meta()
        _state_equal(got.store.state_arrays(), exp.store.state_arrays())
        _search_equal(got, exp, q, x)


def test_snapshot_validation_and_refusals(data, tmp_path):
    _, tidx = _pair("padded", data)
    tidx.save(str(tmp_path))
    m = read_manifest(str(tmp_path))
    m["arrays"]["centroids"]["shape"] = [K + 1, D]
    with open(tmp_path / "index_manifest.json", "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="'centroids'"):
        load_index(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "none"), device="cpu")
    # restoring onto a mesh (queue A item 6b, which raised until it was
    # ported): the validation holds there too, and a valid snapshot loads
    from repro_torch.core import parallel as par
    try:
        pk = par.ParallelContext(par.build_mesh(
            (1, 1), ("data", "model"), device_type="cpu"), k_axis="model")
        with pytest.raises(ValueError, match="'centroids'"):
            IVFIndex.load(str(tmp_path), pctx=pk)
        tidx.save(str(tmp_path / "ok"))
        back = IVFIndex.load(str(tmp_path / "ok"), pctx=pk)
        assert back._k_sharded and back.n_total == tidx.n_total
    finally:
        par.release_world()
    # a bfloat16 index is written (as the reference writes it) and its
    # load fails where the reference's does: the manifest says bfloat16,
    # the npz holds |V2 records
    bf = IVFIndex(tidx.centroids.to(torch.bfloat16), 8, device="cpu")
    bf.save(str(tmp_path / "bf16"))
    with pytest.raises(ValueError, match=r"'centroids': manifest says "
                       r"\[16, 16\] bfloat16, found \[16, 16\] \|V2"):
        load_index(str(tmp_path / "bf16"), device="cpu")


def test_clone_shares_no_storage(data):
    """The last-known-good clone is a copy on the device: a later add to
    the live index (the stores append in place) leaves its search and its
    state unchanged."""
    x, _, q = data
    for kind in ("padded", "q8-paged"):
        _, tidx = _pair(kind, data)
        clone = clone_index(tidx)
        assert clone.faults is None
        ids0, d0 = clone.search(q, topk=10, nprobe=4)
        st0 = clone.store.state_arrays()
        tidx.add(q + 0.01)
        tidx.refresh()
        ids1, d1 = clone.search(q, topk=10, nprobe=4)
        assert torch.equal(ids0, ids1) and torch.equal(d0, d1)
        _state_equal(clone.store.state_arrays(), st0)
        assert clone.n_total == N and tidx.n_total == N + NQ


# --- checkpoints and WAL records in both directions -------------------------

STATE = {"w": np.arange(12, dtype=np.float32).reshape(4, 3),
         "b": [np.zeros(3, np.float32), {"s": np.int32(7)}],
         "t": (np.ones((2, 2), np.float32),), "none": None}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross(writer, tmp_path):
    tstate = {"w": torch.from_numpy(STATE["w"]),
              "b": [torch.zeros(3), {"s": torch.tensor(7, dtype=torch.int32)}],
              "t": (torch.ones(2, 2),), "none": None}
    jstate = {"w": jnp.asarray(STATE["w"]),
              "b": [jnp.zeros(3), {"s": jnp.asarray(7, jnp.int32)}],
              "t": (jnp.ones((2, 2)),), "none": None}
    if writer == "port":
        Checkpointer(str(tmp_path)).save(5, tstate, blocking=True)
        back = JCheckpointer(str(tmp_path)).restore(5, jstate)
        for got, exp in zip(jax_leaves(back), jax_leaves(jstate)):
            assert np.array_equal(np.asarray(got), np.asarray(exp))
    else:
        JCheckpointer(str(tmp_path)).save(5, jstate, blocking=True)
        back = Checkpointer(str(tmp_path)).restore(5, tstate, device="cpu")
        assert torch.equal(back["w"], tstate["w"])
        assert torch.equal(back["b"][1]["s"], tstate["b"][1]["s"])
        assert isinstance(back["t"], tuple) and back["none"] is None
    with open(tmp_path / "manifest.json") as f:
        m = json.load(f)
    assert m["keys"] == ["['b'][0]", "['b'][1]['s']", "['t'][0]", "['w']"]
    import jax
    assert m["treedef"] == str(jax.tree_util.tree_structure(jstate)) == \
        _treedef(tstate)


def jax_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree)


def test_checkpointer_keeps_validates_and_waits(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"w": torch.ones(4, 3), "b": torch.zeros(3)}
    for step in (1, 2, 3):
        ck.save(step, state)
    assert ck.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["manifest.json",
                                            "step_00000002.npz",
                                            "step_00000003.npz"]
    back = ck.restore(3, state)
    assert torch.equal(back["w"], state["w"])
    with pytest.raises(ValueError, match="'w'"):
        ck.restore(3, {"w": torch.ones(5, 3), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="missing"):
        ck.restore(3, {"w": torch.ones(4, 3), "extra": torch.zeros(1)})
    # a bfloat16 leaf is written as |V2 records under a bfloat16 manifest
    # entry, and its restore raises as the reference's does
    h = {"h": torch.ones(2, dtype=torch.bfloat16)}
    ck.save(4, h, blocking=True)
    assert read_json(tmp_path / "manifest.json")["arrays"]["['h']"] == {
        "shape": [2], "dtype": "bfloat16"}
    with pytest.raises(TypeError, match=r"\['h'\].*\|V2"):
        ck.restore(4, h)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wal_records_cross(writer, data, tmp_path):
    """Records written by one package replay, bit for bit and in order,
    in the other; the port logs a tensor through its host copy."""
    x, _, _ = data
    batches = [x[:5], x[5:12], x[12:30]]
    log = (AddLog if writer == "port" else JAddLog)(str(tmp_path))
    for i, b in enumerate(batches):
        log.append(i + 1, torch.from_numpy(b) if writer == "port" and i == 1
                   else b)
    reader = (JAddLog if writer == "port" else AddLog)(str(tmp_path))
    got = list(reader.replay(after=1))
    assert [s for s, _ in got] == [2, 3]
    for (_, g), b in zip(got, batches[1:]):
        assert g.dtype == np.float32 and np.array_equal(g, b)
    assert sorted(os.listdir(tmp_path)) == ["wal_00000001.npz",
                                            "wal_00000002.npz",
                                            "wal_00000003.npz"]
    assert reader.truncate(2) == 2 and reader.seqnos() == [3]


def test_snapshot_files_are_the_references(data, tmp_path):
    """File names, npz keys and dtypes: the port's snapshot holds exactly
    the keys the reference's does, and the tmp file never remains."""
    _, tidx = _pair("q8-paged", data)
    tidx.save(str(tmp_path), seqno=12)
    assert sorted(os.listdir(tmp_path)) == ["index_00000012.npz",
                                            "index_manifest.json"]
    with np.load(tmp_path / "index_00000012.npz") as z:
        files = sorted(z.files)
    assert files == sorted(read_manifest(str(tmp_path))["arrays"])
    assert tsnap.MANIFEST == jsnap.MANIFEST


def read_json(path):
    with open(path) as f:
        return json.load(f)


# --- bfloat16 files: the reference's format, refused on load by both -------

def _bits(a: np.ndarray) -> np.ndarray:
    """An array's raw bytes as unsigned ints of its item size."""
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _assert_same_npz(got_path, exp_path, f32_close=()):
    """The same members with the same descr and the same raw bytes; the f32
    statistics named in ``f32_close`` within rtol 1e-5 (the packages sum
    them in different orders)."""
    with np.load(got_path) as g, np.load(exp_path) as e:
        assert sorted(g.files) == sorted(e.files)
        for k in e.files:
            a, b = g[k], e[k]
            assert a.dtype.str == b.dtype.str and a.shape == b.shape, k
            if k in f32_close:
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
            else:
                assert np.array_equal(_bits(a), _bits(b)), k


def _bf16_index_pair(kind):
    """Well-separated blobs (no bfloat16 near-ties), the same bfloat16
    centroids and one add in both packages."""
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((8, D)).astype(np.float32) * 4
    x = centers[rng.integers(0, 8, 300)] + rng.standard_normal(
        (300, D)).astype(np.float32) * 0.3
    c0 = centers + 0.1
    kw = dict(KINDS[kind])
    jidx = JIVF(jnp.asarray(c0, jnp.bfloat16), 32, **kw)
    tidx = IVFIndex(torch.from_numpy(c0).to(torch.bfloat16), 32,
                    device="cpu", **kw)
    jidx.add(jnp.asarray(x, jnp.bfloat16))
    tidx.add(torch.from_numpy(x).to(torch.bfloat16))
    return jidx, tidx


@pytest.mark.parametrize("kind", ["padded", "paged"])
def test_bf16_snapshot_is_the_references(kind, tmp_path):
    """A bfloat16 index's snapshot: the same manifest, the same npz members
    (centroids and buckets as ``|V2`` records of the same bytes), and both
    packages' ``load_index`` refuse both packages' files with the
    reference's ``ValueError``."""
    jidx, tidx = _bf16_index_pair(kind)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jidx.save(dj, seqno=3)
    tidx.save(dt, seqno=3)
    mj, mt = read_manifest(dj), read_manifest(dt)
    assert mt["arrays"] == mj["arrays"]
    bf = sorted(k for k, v in mj["arrays"].items() if v["dtype"] == "bfloat16")
    assert "centroids" in bf and len(bf) == 2
    _assert_same_npz(os.path.join(dt, "index_00000003.npz"),
                     os.path.join(dj, "index_00000003.npz"),
                     f32_close=("stats_sums", "stats_inertia",
                                "pending_sums", "pending_inertia"))
    with np.load(os.path.join(dt, "index_00000003.npz")) as z:
        assert all(z[k].dtype.str == "|V2" for k in bf)
        assert np.array_equal(
            z["centroids"].view(np.int16),
            tidx.centroids.view(torch.int16).numpy())
    msgs = set()
    for d in (dj, dt):
        for load in (JIVF.load, lambda d: load_index(d, device="cpu")):
            with pytest.raises(ValueError, match="manifest mismatch") as e:
                load(d)
            msgs.add(str(e.value))
    (msg,) = msgs    # the same message from either loader on either file
    for k in bf:
        shape = mj["arrays"][k]["shape"]
        assert f"key '{k}': manifest says {shape} bfloat16, found {shape} " \
            "|V2" in msg


@pytest.mark.parametrize("kind", ["padded", "paged"])
def test_bf16_search_brute_never_returns_padding(kind):
    """A bfloat16 pool pads with 0 (the reference's bytes), so its padding
    rows lie at the origin. ``search_brute`` scores them as ``_PAD_COORD``
    rows and returns a plain top-k over the indexed rows for queries near
    the origin, where a row at 0 would beat every real one; the reference's
    ``search_brute`` returns padding (id -1) there, which shows that the
    queries reach the case."""
    jidx, tidx = _bf16_index_pair(kind)
    x, ids = tidx.store.flat()
    assert (ids < 0).any() and (x[ids < 0] == 0).all()
    q = np.random.default_rng(7).standard_normal((6, D)).astype(
        np.float32) * 0.1
    qt = torch.from_numpy(q).to(torch.bfloat16)
    got_ids, got_d = tidx.search_brute(qt, topk=5)
    real = ids >= 0
    xr, idr = x[real].float(), ids[real]
    d2 = ((qt.float()[:, None, :] - xr[None]) ** 2).sum(-1)
    want_d, pos = torch.sort(d2, dim=1, stable=True)
    assert (got_ids >= 0).all()
    assert torch.equal(got_ids, idr[pos[:, :5]])
    torch.testing.assert_close(got_d, want_d[:, :5], rtol=1e-4, atol=1e-3)
    assert (np.asarray(jidx.search_brute(jnp.asarray(qt.float().numpy(),
                                                     jnp.bfloat16),
                                         topk=5)[0]) == -1).any()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bf16_wal_records_are_the_references(writer, tmp_path):
    """A bfloat16 batch's WAL record holds the reference's ``|V2`` records
    of the same bytes, and both packages' ``replay`` yield that ``|V2``
    array."""
    x = np.random.default_rng(5).standard_normal((7, D)).astype(np.float32)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    AddLog(str(tmp_path / "port")).append(1, tb)
    JAddLog(str(tmp_path / "jax")).append(1, jnp.asarray(x, jnp.bfloat16))
    _assert_same_npz(tmp_path / "port" / "wal_00000001.npz",
                     tmp_path / "jax" / "wal_00000001.npz")
    for reader in (AddLog, JAddLog):
        ((s, got),) = list(reader(str(tmp_path / writer)).replay())
        assert s == 1 and got.dtype.str == "|V2" and got.shape == (7, D)
        assert np.array_equal(got.view(np.int16),
                              tb.view(torch.int16).numpy())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bf16_checkpoints_are_the_references(writer, tmp_path):
    """A checkpoint with a bfloat16 leaf: the same npz bytes and manifest as
    the reference's, and both packages' ``restore`` raise ``TypeError`` on
    the ``|V2`` leaf of either package's file."""
    w = np.arange(12, dtype=np.float32).reshape(4, 3) / 7
    tstate = {"h": torch.from_numpy(w).to(torch.bfloat16),
              "w": torch.from_numpy(w)}
    jstate = {"h": jnp.asarray(w, jnp.bfloat16), "w": jnp.asarray(w)}
    Checkpointer(str(tmp_path / "port")).save(2, tstate, blocking=True)
    JCheckpointer(str(tmp_path / "jax")).save(2, jstate, blocking=True)
    _assert_same_npz(tmp_path / "port" / "step_00000002.npz",
                     tmp_path / "jax" / "step_00000002.npz")
    assert read_json(tmp_path / "port" / "manifest.json") == \
        read_json(tmp_path / "jax" / "manifest.json")
    d = str(tmp_path / writer)
    with pytest.raises(TypeError, match=r"\|V2"):
        JCheckpointer(d).restore(2, jstate)
    with pytest.raises(TypeError, match=r"\['h'\].*\|V2"):
        Checkpointer(d).restore(2, tstate, device="cpu")
