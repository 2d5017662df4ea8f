"""The port's FlashProbe wrappers and oracle against the JAX package, on
the CPU.

The same numpy inputs (from a seed) go through ``repro`` (Pallas in
interpret mode, as its own tests run it) and ``repro_torch`` (whose
wrappers run the kernels' plain versions for CPU tensors). The data is
continuous and random, so there are no ties except the ones a test builds
on purpose. Tolerance: ids equal; scores and distances within
``rtol=1e-5`` plus ``atol = 1e-5 * (max ||q||^2 + max ||c||^2)``, the
scale of the expanded form's cancellation (``||q||^2 + ||c||^2 - 2 q.c``
loses digits in proportion to the norms). bf16 inputs: ids equal except
near-ties within that ``atol``; +inf entries of the q8 scan sit in the
same places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heuristics as jheur
from repro.core import quant8 as jq8
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import heuristics as H
from repro_torch.core import plan as P
from repro_torch.core import quant8 as q8
from repro_torch.kernels import flash_probe as fp
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _atol(q, c):
    q, c = np.asarray(q, np.float64), np.asarray(c, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((c * c).sum(-1).max()))


def _assert_topl(ids, vals, jids, jvals, atol, exact_ids=True):
    ids, vals = np.asarray(ids), _np(vals)
    jids, jvals = np.asarray(jids), _np(jvals)
    assert ids.shape == jids.shape and ids.dtype == np.int32
    np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=atol)
    diff = ids != jids
    if exact_ids:
        assert not diff.any(), f"{int(diff.sum())} ids differ"
    else:   # a differing id must sit on a near-tie
        assert np.all(np.abs(vals - jvals)[diff] <= atol)


# --- the oracle ----------------------------------------------------------

@pytest.mark.parametrize("n,k,d,l", [(32, 16, 16, 4), (32, 16, 19, 16),
                                     (7, 4, 19, 1)])
@pytest.mark.parametrize("want_dists", [True, False])
def test_probe_ref_matches_jax(n, k, d, l, want_dists):
    rng = np.random.default_rng(n + k + d)
    q = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    idx, v = ref.probe_ref(torch.from_numpy(q), torch.from_numpy(c), l,
                           want_dists=want_dists)
    jidx, jv = jref.probe_ref(jnp.asarray(q), jnp.asarray(c), l,
                              want_dists=want_dists)
    _assert_topl(idx, v, jidx, jv, _atol(q, c))


def test_probe_ref_ties_go_to_the_lower_index():
    c = np.repeat(np.eye(4, 8, dtype=np.float32), 3, axis=0)   # 12 rows
    q = np.eye(4, 8, dtype=np.float32)[[2, 0]]
    idx, _ = ref.probe_ref(torch.from_numpy(q), torch.from_numpy(c), 5)
    jidx, _ = jref.probe_ref(jnp.asarray(q), jnp.asarray(c), 5)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, :3].tolist() == [6, 7, 8]


# --- kernel 4: flash_probe -------------------------------------------------

PROBE_SHAPES = [(32, 16, 16, 4), (33, 17, 19, 7), (32, 16, 16, 16),
                (1, 4, 19, 1), (5, 40, 1, 40)]


@pytest.mark.parametrize("n,k,d,l", PROBE_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pass_csq", [False, True])
def test_flash_probe_matches_jax(n, k, d, l, dt, pass_csq):
    rng = np.random.default_rng(3 * n + k + d)
    q = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    tq, tc = torch.from_numpy(q).to(tdt), torch.from_numpy(c).to(tdt)
    jq, jc = jnp.asarray(q, jdt), jnp.asarray(c, jdt)
    c32 = np.asarray(jc, np.float32)
    csq = (c32 * c32).sum(-1)
    for want in (True, False):
        got = ops.flash_probe(tq, tc, l=l, want_dists=want,
                              c_sq=torch.from_numpy(csq) if pass_csq
                              else None)
        exp = jops.flash_probe(jq, jc, l=l, want_dists=want,
                               c_sq=jnp.asarray(csq) if pass_csq else None)
        _assert_topl(*got, *exp, _atol(q, c), exact_ids=dt == "f32")


def test_flash_probe_duplicates_keep_the_lower_index():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((6, 16)).astype(np.float32)
    c = np.concatenate([base, base[::-1], base])      # every row 3 times
    q = rng.standard_normal((9, 16)).astype(np.float32)
    got = ops.flash_probe(torch.from_numpy(q), torch.from_numpy(c), l=18,
                          want_dists=False)
    exp = jops.flash_probe(jnp.asarray(q), jnp.asarray(c), l=18,
                           want_dists=False)
    assert np.array_equal(got[0].numpy(), np.asarray(exp[0]))
    ids = got[0].numpy()
    for row, vals in zip(ids, got[1].numpy()):   # equal scores: ascending ids
        for j in range(len(row) - 1):
            if vals[j] == vals[j + 1]:
                assert row[j] < row[j + 1]


# --- kernel 5: flash_probe_grouped -----------------------------------------

@pytest.mark.parametrize("b,cn,d,l", [(32, 64, 16, 10), (9, 37, 19, 37),
                                      (1, 5, 1, 1), (4, 130, 19, 7)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_probe_grouped_matches_jax(b, cn, d, l, dt):
    rng = np.random.default_rng(b + cn + d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((b, cn, d)).astype(np.float32)
    c[:, cn // 2: cn // 2 + 2] = 1e15      # store padding rows: finite, last
    tdt, jdt = DTYPES[dt]
    got = ops.flash_probe_grouped(torch.from_numpy(q).to(tdt),
                                  torch.from_numpy(c).to(tdt), l=l)
    exp = jops.flash_probe_grouped(jnp.asarray(q, jdt), jnp.asarray(c, jdt),
                                   l=l)
    live = np.concatenate([c[:, :cn // 2], c[:, cn // 2 + 2:]], axis=1)
    if l <= live.shape[1]:
        assert np.isfinite(got[1].numpy()).all()
        _assert_topl(*got, *exp, _atol(q, live[0]), exact_ids=dt == "f32")
    else:    # padding rows are selected last, at finite huge scores
        assert np.isfinite(got[1].numpy()).all()
        assert np.array_equal(got[0][:, :live.shape[1]].numpy(),
                              np.asarray(exp[0])[:, :live.shape[1]])


# --- kernel 6: flash_probe_grouped_q8 --------------------------------------

def _q8_inputs(b, p, w, d, seed, dead_frac=0.3):
    rng = np.random.default_rng(seed)
    qp = rng.standard_normal((b, p, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (b, p, w, d)).astype(np.int8)
    scales = (rng.random((b, p, w)) * 0.02 + 1e-3).astype(np.float32)
    scales[rng.random((b, p, w)) < dead_frac] = 0.0
    return qp, codes, scales


@pytest.mark.parametrize("b,p,w,d,l", [(32, 4, 16, 16, 10), (5, 3, 13, 19, 7),
                                       (1, 2, 5, 16, 10), (4, 5, 9, 1, 40)])
def test_flash_probe_grouped_q8_matches_jax(b, p, w, d, l):
    qp, codes, scales = _q8_inputs(b, p, w, d, seed=b * p + w + d)
    scales[0, :, :] = 0.0
    scales[0, 0, :2] = 1e-2        # a row with fewer live slots than l
    got = ops.flash_probe_grouped_q8(torch.from_numpy(qp),
                                     torch.from_numpy(codes),
                                     torch.from_numpy(scales), l=l)
    exp = jops.flash_probe_grouped_q8(jnp.asarray(qp), jnp.asarray(codes),
                                      jnp.asarray(scales), l=l)
    v, jv = got[1].numpy(), np.asarray(exp[1])
    fin = np.isfinite(jv)
    assert np.array_equal(np.isfinite(v), fin)       # +inf in the same places
    assert (~fin[0]).sum() == l - 2
    r = codes.astype(np.float32) * scales[..., None]
    atol = _atol(qp.reshape(-1, d), r.reshape(-1, d))
    np.testing.assert_allclose(v[fin], jv[fin], rtol=1e-5, atol=atol)
    assert np.array_equal(got[0].numpy()[fin], np.asarray(exp[0])[fin])
    assert got[0].min() >= 0 and got[0].max() < p * w


# --- contracts -------------------------------------------------------------

def test_l_out_of_range_raises():
    q, c = torch.zeros(3, 4), torch.zeros(5, 4)
    for l in (0, 6):
        with pytest.raises(ValueError):
            ops.flash_probe(q, c, l=l)
        with pytest.raises(ValueError):
            ops.flash_probe_grouped(q, c.expand(3, 5, 4), l=l)
    codes = torch.zeros(3, 2, 2, 4, dtype=torch.int8)
    for l in (0, 5):
        with pytest.raises(ValueError):
            ops.flash_probe_grouped_q8(torch.zeros(3, 2, 4), codes,
                                       torch.ones(3, 2, 2), l=l)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        fp.flash_probe_raw(torch.zeros(2, 3), torch.zeros(4, 3,
                           dtype=torch.float64), torch.zeros(4), 1)
    with pytest.raises(TypeError):
        fp.flash_probe_raw(torch.zeros(2, 3), torch.zeros(4, 3),
                           torch.zeros(5), 1)
    with pytest.raises(TypeError):
        fp.flash_probe_grouped_q8_raw(
            torch.zeros(2, 1, 3), torch.zeros(2, 1, 2, 3), torch.ones(2, 1, 2),
            1)
    with pytest.raises(ValueError):
        fp.flash_probe_grouped_raw(torch.zeros(2, 3), torch.zeros(3, 4, 3), 1)


@pytest.mark.parametrize("c,l,splits", [(1, 1, 1), (10, 3, 4), (9, 9, 4),
                                        (18400, 10, 3), (77000, 77000, 33),
                                        (5, 2, 100)])
def test_launch_geometry_covers_every_row(c, l, splits):
    s, chunk, lp = fp._launch_geometry(c, l, splits)
    assert 1 <= s <= max(1, splits) and (s - 1) * chunk < c <= s * chunk
    assert lp == min(l, chunk) and s * lp >= l


def test_list_scratch_only_beyond_shared_memory():
    ptrs, keep = fp._buffers(3, 10, 1, 10, "cpu")
    assert ptrs[2] == ptrs[0] and ptrs[4:] == (None,) * 4   # part == out
    big = fp.LIST_SMEM_MAX + 1
    ptrs, keep = fp._buffers(2, big, 4, big, "cpu")
    assert None not in ptrs
    assert keep[4].shape == (8, 2, big) and keep[6].shape == (2, 2, big)


# --- planner and int8 convention --------------------------------------------

@pytest.mark.parametrize("op,shape", [
    ("probe", (256, 1024, 128, 16)), ("probe", (256, 1024, 128, 1024)),
    ("scan", (256, 18400, 128, 10)), ("scan_q8", (256, 18400, 128, 40)),
    ("scan_q8", (16, 77000, 128, 77000)), ("scan", (1, 5, 1, 1))])
def test_probe_plans_fit_shared_memory(op, shape):
    planner = P.KernelPlanner(H.hopper_row("h100_test"))
    p = planner.plan(op, shape, 1 if op == "scan_q8" else 4)
    splits, tile = p.blocks
    assert tile == fp.TILE and splits >= 1
    assert p.smem_bytes <= p.smem_limit
    assert planner.plan(op, shape, 1 if op == "scan_q8" else 4) is p
    assert planner.chooser_calls == 1


def test_wrappers_take_a_plan_for_their_own_op():
    planner = P.KernelPlanner(H.CPU)
    q, c = torch.randn(6, 8), torch.randn(40, 8)
    plan = planner.plan("probe", (6, 40, 8, 5), torch.float32)
    got = ops.flash_probe(q, c, l=5, plan=plan)
    exp = ops.flash_probe(q, c, l=5, splits=3)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    with pytest.raises(ValueError, match="cannot drive"):
        ops.flash_probe_grouped(q, c.expand(6, 40, 8), l=5, plan=plan)


def test_choose_rescore_mult_matches_jax():
    for topk in (1, 10, 100):
        for d in (16, 128):
            for cand in (10, 100, 1000, 3000, 100000):
                assert H.choose_rescore_mult(topk, d, cand) == \
                    jheur.choose_rescore_mult(topk, d, cand)


def test_quant8_codes_equal_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 19)).astype(np.float32) * 3
    x[0, :4] = [0.5, 1.5, -2.5, 0.0]          # halves round to even
    x[1] = 0.0                                # all-zero row: SCALE_EPS
    absmax = np.abs(x).max(-1)
    s = q8.symmetric_scale(torch.from_numpy(absmax))
    js = jq8.symmetric_scale(jnp.asarray(absmax))
    assert np.array_equal(s.numpy(), np.asarray(js))
    codes = q8.quantize_symmetric(torch.from_numpy(x), s.unsqueeze(-1))
    jcodes = jq8.quantize_symmetric(jnp.asarray(x), js[:, None])
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    dec = q8.dequantize_symmetric(codes, s.unsqueeze(-1))
    assert np.array_equal(dec.numpy(),
                          np.asarray(jq8.dequantize_symmetric(jcodes,
                                                              js[:, None])))
    ones = torch.ones(3)
    assert q8.quantize_symmetric(torch.tensor([0.5, 1.5, 2.5]),
                                 ones).tolist() == [0, 2, 2]
