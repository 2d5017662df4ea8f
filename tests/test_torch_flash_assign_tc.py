"""FlashAssign's tensor-core arithmetic, emulated on the CPU.

The kernel (``csrc/flash_assign.cu``) runs only on the card. Its arithmetic
for float32 inputs is emulated here in plain PyTorch: ``cvt.rna.tf32.f32``
by bit operations (round to nearest, ties away from zero, 13 low mantissa
bits cleared), each operand split ``v = hi + lo``, and per k-step of 8
features the three products ``x_lo c_hi``, ``x_hi c_lo``, ``x_hi c_hi``
added in that order into one fp32 accumulator. The emulation is held
against float64 within ``flash_assign.score_tol`` and against the JAX
package's ``flash_assign`` ids on tie-free rows; the same arithmetic with
fewer products is shown to break ``score_tol``. The wrapper's feature
padding (the path TMA needs for d % 4 != 0 in f32, d % 8 != 0 in bf16) is
checked through the plain version. The launch that returns distances sums
``||x||^2`` in its consumers (per-thread pieces of 16 bytes, then a xor
tree); that order is emulated too, held against float64 within its chain
bound, and the distances within ``flash_assign.dist_tol`` of the plain
version's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_assign as fa

N, K = 200, 37


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of f32 values: adding half of the dropped
    13-bit ulp to the sign-magnitude bits rounds half away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def scores_3xtf32(x: torch.Tensor, c: torch.Tensor,
                  drop_x_lo: bool = False) -> torch.Tensor:
    """(N, K) ``||c||^2 - 2 x.c`` as the kernel computes it in f32; with
    ``drop_x_lo`` the kernel's ``x_lo c_hi`` term is lost."""
    (xh, xl), (ch, cl) = split(x), split(c)
    acc = torch.zeros((x.shape[0], c.shape[0]), dtype=torch.float32)
    for j in range(0, x.shape[1], 8):
        s = slice(j, j + 8)
        if not drop_x_lo:
            acc = acc + xl[:, s] @ ch[:, s].T
        acc = acc + xh[:, s] @ cl[:, s].T
        acc = acc + xh[:, s] @ ch[:, s].T
    return (c * c).sum(-1) - 2.0 * acc


def scores_tf32(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One TF32 product per term (what the kernel does not do)."""
    return (c * c).sum(-1) - 2.0 * (tf32_rna(x) @ tf32_rna(c).T)


def exact(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x64, c64 = x.double(), c.double()
    return (c64 * c64).sum(-1) - 2.0 * (x64 @ c64.T)


def aligned(rng, shape) -> np.ndarray:
    """Values in [1, 1 + 1/16) whose 13 low mantissa bits are 0x0fff:
    ``cvt.rna.tf32`` rounds each down by almost half its ulp, so every TF32
    product errs the same way."""
    v = (1.0 + rng.uniform(0, 1 / 16, shape)).astype(np.float32)
    return (v.view(np.int32) & -0x2000 | 0x0fff).view(np.float32)


def make(kind: str, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, d))
    c = rng.standard_normal((K, d))
    if kind == "far":          # points and centroids far from the origin
        x, c = x + 50.0, c + 50.0
    elif kind == "mixed":      # both signs over six decades of magnitude
        x = x * 10.0 ** rng.uniform(-3, 3, (N, d))
        c = c * 10.0 ** rng.uniform(-3, 3, (K, d))
    elif kind == "duplicated":  # the second half repeats the first
        c[K // 2:2 * (K // 2)] = c[:K // 2]
    elif kind == "aligned":
        x, c = aligned(rng, (N, d)), aligned(rng, (K, d))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(c.astype(np.float32)))


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                      # tf32 ulp at [1, 2)
    v = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23,
                      1.0 + 3 * ulp / 2, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0])
    assert torch.equal(tf32_rna(v), want)
    x = torch.randn(1000) * 1e3
    hi, lo = split(x)
    assert torch.equal(hi.view(torch.int32) & 0x1fff,
                       torch.zeros(1000, dtype=torch.int32))
    assert bool(((x.double() - hi.double() - lo.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("kind", ["random", "far", "mixed", "duplicated",
                                  "aligned"])
@pytest.mark.parametrize("d", [1, 3, 19, 128, 512])
def test_3xtf32_error_within_score_tol(kind, d):
    x, c = make(kind, d)
    got = scores_3xtf32(x, c)
    tol = fa.score_tol(x, c)
    err = float((got.double() - exact(x, c)).abs().max())
    assert err <= tol, (err, tol)
    if kind == "duplicated":   # equal rows score bitwise equal: the kernel's
        h = K // 2             # strict '<' keeps the lower index
        assert torch.equal(got[:, :h], got[:, h:2 * h])
        a = got.argmin(1)
        assert not bool(((a >= h) & (a < 2 * h)).any())


@pytest.mark.parametrize("d", [1, 3])
def test_one_tf32_product_breaks_the_bound(d):
    """Plain TF32 misses the bound that 3xTF32 keeps (why the kernel takes
    three products)."""
    x, c = make("far", d)
    tol = fa.score_tol(x, c)
    assert float((scores_tf32(x, c).double() - exact(x, c)).abs().max()) \
        > tol
    assert float((scores_3xtf32(x, c).double() - exact(x, c)).abs().max()) \
        <= tol


@pytest.mark.parametrize("variant", ["tf32", "drop_x_lo"])
@pytest.mark.parametrize("kind,d", [("far", 3), ("far", 19), ("aligned", 128),
                                    ("aligned", 512)])
def test_fewer_tf32_products_break_the_bound(variant, kind, d):
    """The controls that chip_smoke.py sends through the kernel's check: one
    TF32 product, or the three with ``x_lo c_hi`` lost, miss ``score_tol``
    on far data at small d and on aligned data up to d = 512; the kernel's
    three products keep it."""
    x, c = make(kind, d)
    got = (scores_tf32(x, c) if variant == "tf32"
           else scores_3xtf32(x, c, drop_x_lo=True))
    tol = fa.score_tol(x, c)
    assert float((got.double() - exact(x, c)).abs().max()) > tol
    assert float((scores_3xtf32(x, c).double() - exact(x, c)).abs().max()) \
        <= tol


@pytest.mark.parametrize("kind", ["random", "mixed"])
@pytest.mark.parametrize("d", [3, 19, 128])
def test_3xtf32_ids_match_jax_on_tie_free_rows(kind, d):
    x, c = make(kind, d, seed=1)
    got = scores_3xtf32(x, c).argmin(1)
    ja, _ = jops.flash_assign(jnp.asarray(x.numpy()), jnp.asarray(c.numpy()))
    ex = exact(x, c).sort(1).values
    tie_free = (ex[:, 1] - ex[:, 0]) > 2 * fa.score_tol(x, c)
    assert int(tie_free.sum()) >= N // 2
    ja = torch.from_numpy(np.array(ja)).long()
    assert torch.equal(got[tie_free], ja[tie_free])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 3, 8, 12, 19, 129])
def test_feature_padding_changes_no_score(dt, d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((2, 150, d),
                                             dtype=np.float32)).to(dt)
    c = torch.from_numpy(rng.standard_normal((2, 9, d),
                                             dtype=np.float32)).to(dt)
    xp, cp = fa.pad_features(x, c)
    align = 4 if dt == torch.float32 else 8
    dp = xp.shape[-1]
    assert dp % align == 0 and dp - d < align and cp.shape[-1] == dp
    assert xp.is_contiguous() and cp.is_contiguous()
    assert torch.equal(xp[..., :d], x) and torch.equal(cp[..., :d], c)
    assert not bool(xp[..., d:].any()) and not bool(cp[..., d:].any())
    if dp == d:   # aligned widths are not copied
        assert xp.data_ptr() == x.data_ptr() and cp.data_ptr() == c.data_ptr()
    a, m = fa.flash_assign_plain(x, c)
    ap, mp = fa.flash_assign_plain(xp, cp)
    assert torch.equal(a, ap)
    assert float((m - mp).abs().max()) <= fa.score_tol(x, c)


def sq_consumers(x: torch.Tensor) -> torch.Tensor:
    """(N,) ``||x||^2`` as FlashAssign's consumers sum it for the launch
    that returns distances (``argmin<kSq>``, ``csrc/tc_argmin.cuh``): each
    128-byte stage row (chunk) of a row is 8 pieces of 16 bytes; the thread
    that holds piece p (the swizzle moves which thread, not which values)
    adds the squares of the piece's values into one fp32 accumulator, chunk
    after chunk, one fused multiply-add (a single rounding) a value: in f32
    the 4 values in order, in bf16 each pair odd value first (``fmaf(x, x,
    fmaf(y, y, s))``); the tail past d is zeros. A xor tree then adds the 8
    pieces: ``((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7))``. The fused
    step is emulated in float64 (the square is exact there) and rounded to
    fp32."""
    itemsize = x.element_size()
    per = 16 // itemsize
    chunk = fa.ROW_BYTES // itemsize
    d = x.shape[-1]
    v = torch.nn.functional.pad(x.double(), (0, -d % chunk))
    v = v.reshape(x.shape[0], -1, 8, per)   # (N, chunks, piece, value)
    order = list(range(per)) if itemsize == 4 else [
        e ^ 1 for e in range(per)]
    s = torch.zeros((x.shape[0], 8), dtype=torch.float32)
    for ch in range(v.shape[1]):
        for e in order:
            s = (s.double() + v[:, ch, :, e] ** 2).float()
    t = [s[:, p] + s[:, p ^ 1] for p in range(0, 8, 2)]
    return (t[0] + t[1]) + (t[2] + t[3])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "far", "mixed", "aligned"])
@pytest.mark.parametrize("d", [1, 3, 19, 128, 129, 512])
def test_consumers_norms_within_their_chain_bound(dt, kind, d):
    """The consumers' ``||x||^2`` misses float64 by at most ``h u ||x||^2``
    (``h = sq_chain``: a piece's fused square-adds, then the 3-level tree)."""
    x, _ = make(kind, d)
    x = x.to(dt)
    h = fa.sq_chain(d, x.element_size())
    assert h <= d // 8 + 11
    got = sq_consumers(x).double()
    exact64 = (x.double() ** 2).sum(-1)
    assert bool(((got - exact64).abs()
                 <= h * fa.U32 * exact64 * (1 + 1 / 64)).all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "far", "mixed", "duplicated",
                                  "aligned"])
@pytest.mark.parametrize("d", [1, 3, 19, 128, 512])
def test_kernel_distances_within_dist_tol(dt, kind, d):
    """The kernel's distance ``max(m + ||x||^2, 0)`` (its f32 scores
    emulated as 3xTF32, bf16 scores exact products in float64, its norms in
    the consumers' order, the final addition in fp32) lies within
    ``dist_tol`` of the plain version's (``want_dists``), which itself adds
    ``(x * x).sum(-1)`` as the JAX package does; the plain version's
    distances are its scores plus that sum, clamped at 0."""
    x, c = make(kind, d)
    x, c = x.to(dt), c.to(dt)
    if dt == torch.float32:
        score = scores_3xtf32(x, c)
    else:
        score = exact(x.float(), c.float()).float()
    m = score.min(1).values
    got = torch.clamp(m + sq_consumers(x), min=0.0)
    a_p, want = fa.flash_assign_plain(x[None], c[None], want_dists=True)
    a_s, m_p = fa.flash_assign_plain(x[None], c[None])
    assert torch.equal(a_p, a_s)
    x32 = x.float()
    assert torch.equal(want[0], torch.clamp(m_p[0] + (x32 * x32).sum(-1),
                                            min=0.0))
    tol = fa.dist_tol(x, c)
    assert tol > fa.score_tol(x, c)
    err = float((got - want[0]).abs().max())
    assert err <= tol, (err, tol)
