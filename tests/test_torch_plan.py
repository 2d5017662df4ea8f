"""The port's planner for Hopper, checked here with rows built from explicit
values (no card needed)."""
import dataclasses

import pytest
import torch

from repro.core.plan import bucket_dim as jax_bucket_dim
from repro_torch.core import heuristics as H
from repro_torch.core import plan as P
from repro_torch.core import KMeansConfig
from repro_torch.kernels import ops
from repro_torch.kernels import sort_inverse_update as siu


def fused_smem_bytes(k, d, itemsize=4):
    """FlashLloyd's shared memory a CTA at the planner's cluster size."""
    return H.fused_footprint(k, d, itemsize,
                             H.choose_lloyd_cluster(k, d, itemsize, H100))


H100 = H.hopper_row("h100_test", num_sms=132, l2_bytes=50 * 2**20,
                    smem_block_bytes=232_448)
# a row whose tensor cores run no faster than its CUDA cores
CUDA_CORES = dataclasses.replace(H100, flops_tf32=3 * H100.flops_f32,
                                 flops_bf16=H100.flops_f32)
# the largest K at which the planner takes the fused step at d = 128
K_CROSS_F32, K_CROSS_BF16 = 256, 1336


@pytest.mark.parametrize("itemsize", [4, 2])
def test_paper_regimes_plan_as_expected(itemsize):
    # both paths run the tensor-core argmin; at smallN_smallK FlashLloyd's
    # additions beat the update's and the ||x||^2 pass's bytes; at K = 1,024
    # its f32 re-split of the streamed x for each of 8 centroid tiles costs
    # more than they do, its bf16 additions less; K = 65,536 at d = 512 fits
    # no cluster
    planner = P.KernelPlanner(H100)
    f32 = itemsize == 4
    assert planner.plan("step", (65536, 256, 128), itemsize).impl == "fused"
    assert planner.plan("step", (8388608, 1024, 128),
                        itemsize).impl == ("two_pass" if f32 else "fused")
    assert planner.plan("step", (65536, 1024, 128), itemsize).impl == \
        ("two_pass" if f32 else "fused")
    assert planner.plan("step", (262144, 65536, 512),
                        itemsize).impl == "two_pass"


SHAPES = [(n, k, d) for n in (100, 65536, 8388608)
          for k in (1, 7, 256, 400, 431, 1024, 65536) for d in (3, 128, 512)]


@pytest.mark.parametrize("op", ["assign", "update", "step"])
def test_no_planned_tile_exceeds_shared_memory(op):
    planner = P.KernelPlanner(H100)
    for shape in SHAPES:
        for itemsize in (2, 4):
            p = planner.plan(op, shape, itemsize)
            assert p.smem_bytes <= p.smem_limit == H100.smem_block_bytes
            blk = p.block.validate()
            n, k, d = shape
            assert H.assign_footprint(blk.assign_block_n, blk.assign_block_k,
                                      d, itemsize) <= H100.smem_block_bytes
            if op == "step" and p.impl == "fused":
                assert p.cluster == H.choose_lloyd_cluster(k, d, itemsize,
                                                           H100)
                assert fused_smem_bytes(k, d, itemsize) \
                    <= H100.smem_block_bytes
                assert p.smem_bytes == fused_smem_bytes(k, d, itemsize)
            elif op == "step":
                assert p.cluster is None


def test_fused_window_is_the_shared_memory_bound():
    """Each cluster size's window ends where its slice stops fitting, the
    next size takes over, and past C = 8's window no size fits: at d = 128
    it reaches the old single-CTA window (K <= 430) and beyond."""
    for itemsize in (4, 2):
        edges = [H.max_fused_k(128, itemsize, cl, H100) for cl in (1, 2, 4, 8)]
        assert edges == [188, 370, 716, 1336]
        for cl, kmax in zip((1, 2, 4, 8), edges):
            assert H.fused_footprint(kmax, 128, itemsize, cl) \
                <= H100.smem_block_bytes
            assert H.fused_footprint(kmax + 1, 128, itemsize, cl) \
                > H100.smem_block_bytes
            assert H.choose_lloyd_cluster(kmax, 128, itemsize, H100) == cl
            assert H.choose_lloyd_cluster(kmax + 1, 128, itemsize, H100) \
                == (2 * cl if cl < 8 else None)
        assert edges[-1] >= 430
        assert H.choose_step_impl(65536, edges[-1] + 1, 128,
                                  dtype_bytes=itemsize,
                                  hw=CUDA_CORES) == "two_pass"
    # the ring, alignment, counters and lists, and 4 (K d + K) / C bytes of
    # sums and counts at C = 2 (chip_smoke.py checks the model against the
    # compiled kernel's shared memory at every C)
    assert fused_smem_bytes(256, 128) == 131104 + 1024 + 1632 + 3072 \
        + 4 * (128 * 128 + 128)


@pytest.mark.parametrize("itemsize,d,want", [
    (4, 128, 230_448), (4, 3, 230_448), (4, 129, 197_680), (4, 512, 197_680),
    (2, 128, 132_160), (2, 256, 132_160), (2, 512, 132_160)])
def test_assign_footprint_is_the_kernels_layout(itemsize, d, want):
    """FlashAssign's dynamic shared memory (chip_smoke.py reads the same
    numbers back from the compiled kernel): f32 keeps x and its tf32 low
    part resident up to d = 128 (128 KB) beside a 3-stage ring of c_hi and
    c_lo (32 KB a stage), else a 3-stage ring of all four (64 KB a stage);
    bf16 keeps x resident up to d = 256 (64 KB) beside a 4-stage ring of c
    (16 KB), else a 4-stage ring of x and c (32 KB). Plus 16 bytes of
    mbarriers a stage and 1,024 of alignment."""
    assert H.assign_footprint(128, 128, d, itemsize) == want
    assert want <= H100.smem_block_bytes


def test_roofline_leg_uses_the_rows_peaks():
    fast_mem = dataclasses.replace(H100, hbm_bw=1e15)
    # with a memory system so fast that the update's and the ||x||^2
    # pass's bytes cost nothing, FlashLloyd's measured additions lose
    assert H.choose_step_impl(65536, 256, 128, hw=H100) == "fused"
    assert H.choose_step_impl(65536, 256, 128, hw=fast_mem) == "two_pass"
    # both legs run the argmin at the row's TF32 (f32, three products) and
    # bf16 tensor-core rates
    for itemsize in (4, 2):
        assert H.choose_step_impl(65536, 256, 128, dtype_bytes=itemsize,
                                  hw=H100) == "fused"
    assert H.assign_flops_rate(4, H100) == H100.flops_tf32 / 3
    assert H.assign_flops_rate(2, H100) == H100.flops_bf16


@pytest.mark.parametrize("itemsize,k_cross", [(4, K_CROSS_F32),
                                              (2, K_CROSS_BF16)])
def test_fused_two_pass_crossover(itemsize, k_cross):
    """The crossover at N = 65,536 and 8,388,608, d = 128. f32: through
    K = 256 (two centroid tiles) FlashLloyd's one re-split of the streamed
    x and its additions cost less than the update's and the ||x||^2 pass's
    bytes; from the third tile on the re-splits cost more. bf16 has no
    split: fused wherever a cluster size fits (K <= 1,336)."""
    for n in (65536, 8388608):
        assert H.choose_step_impl(n, k_cross, 128, dtype_bytes=itemsize,
                                  hw=H100) == "fused"
        assert H.choose_step_impl(n, k_cross + 1, 128, dtype_bytes=itemsize,
                                  hw=H100) == "two_pass"


def test_choose_blocks_update_tiles():
    """The sort-inverse CTA: 256 threads, the fewest sorted rows (a power of
    two in [64, 2048]) that keep every CTA resident in one wave, so that at
    small N all of its gathers are in flight at once."""
    for n, d in ((100, 3), (65536, 128), (8388608, 128), (262144, 512)):
        blk = H.choose_blocks(n, 1024, d, hw=H100).validate()
        chunk = blk.update_block_n
        assert H.UPDATE_MIN_CHUNK <= chunk <= H.UPDATE_MAX_CHUNK == 2048
        assert blk.update_block_k == H.UPDATE_THREADS == 256
        assert (blk.assign_block_n, blk.assign_block_k) == (128, 128)
        assert (blk.fused_block_n, blk.fused_block_k) == (128, 128)
        ctas = -(-n // chunk)
        resident = H100.num_sms * H.update_ctas_per_sm(d, 4, chunk, H100)
        if chunk < H.UPDATE_MAX_CHUNK:   # one wave, and no shorter chunk is
            assert ctas <= resident      # one
            assert chunk == H.UPDATE_MIN_CHUNK or -(-n // (chunk // 2)) \
                > resident
        assert H.update_footprint(chunk, 256, d, 4) <= H100.smem_block_bytes
    # smallN_smallK: 256 rows a CTA, 256 CTAs within 3 a SM on 132 SMs
    assert H.choose_blocks(65536, 256, 128, hw=H100).update_block_n == 256
    assert H.update_ctas_per_sm(128, 4, 256, H100) == 3
    # the layouts: one f32 row a warp at d = 128, two bf16 rows with 16 lanes
    # each, four vectors a lane at d = 512, the scalar path off the vector
    assert siu.layout(128, 4) == (4, 32, 1)
    assert siu.layout(128, 2) == (8, 16, 1)
    assert siu.layout(512, 4) == (4, 32, 4)
    assert siu.layout(19, 4) == (1, 32, 1)
    assert siu.layout(129, 2) == (1, 32, 4)
    assert siu.layout(128, 4, aligned=False) == (1, 32, 4)
    assert siu.layout(1, 4) == (1, 1, 1)


def test_planner_memo_and_counters():
    planner = P.KernelPlanner(H100)
    p1 = planner.plan("step", (1000, 64, 32))
    assert planner.counters()["chooser_calls"] == 1
    p2 = planner.plan("step", (1020, 64, 32))  # same pow2 bucket
    assert p2 is p1 and planner.hits == 1
    planner.plan("assign", (1000, 64, 32))      # sibling stored with step
    planner.plan("update", (1000, 64, 32))
    assert planner.counters()["chooser_calls"] == 1
    planner.plan("step", (1000, 64, 32), 2)     # other itemsize: new plan
    assert planner.counters()["chooser_calls"] == 2
    pinned = dataclasses.replace(p1.block, update_block_n=256)
    assert planner.step_impl(1000, 64, 32, blk=pinned) == p1.impl
    assert planner.counters()["chooser_calls"] == 3
    assert planner.plan("step", (1000, 64, 32), blk=p1.block) is p1
    with pytest.raises(ValueError, match="unknown plan op"):
        planner.plan("route", (1, 2, 3, 4))     # waits for two_level
    with pytest.raises(ValueError, match="arity"):
        planner.plan("step", (1, 2))


def test_bucket_dim_matches_jax():
    for v in (0, 1, 7, 8, 9, 1000, 1024, 1025, 8388608):
        assert P.bucket_dim(v) == jax_bucket_dim(v)


def test_detect_hardware_cpu_and_missing_cuda(monkeypatch):
    assert P.detect_hardware("cpu") is H.CPU
    assert dataclasses.replace(H.CPU, name=H.H100.name) == H.H100
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.detect_hardware("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.default_planner()


def test_config_auto_uses_the_device_planner():
    cfg = KMeansConfig(k=64)
    assert cfg.resolved_step_impl(65536, 128, 4, device="cpu") == "fused"
    cfg = KMeansConfig(k=1024)
    assert cfg.resolved_step_impl(8388608, 128, 4, device="cpu") == \
        "two_pass"
    planner = P.KernelPlanner(dataclasses.replace(H100, smem_block_bytes=0))
    cfg = KMeansConfig(k=8, planner=planner)
    assert cfg.resolved_step_impl(1000, 4, 4, device="cpu") == "two_pass"


def test_audit_rejects_an_accumulator_that_does_not_fit():
    x, c = torch.randn(64, 128), torch.randn(1337, 128)   # past C = 8
    with pytest.raises(ValueError, match="shared-memory limit"):
        ops.flash_lloyd_step(x, c)
    with pytest.raises(ValueError, match="compiled"):
        ops.flash_lloyd_step(x, c[:8], block_n=128, block_k=64)


@pytest.mark.parametrize("itemsize,d,windows,at256", [
    (4, 1, [4857, 9560, 18508, 34560], 140416),
    (4, 19, [1156, 2276, 4404, 8224], 156800),
    (4, 128, [188, 370, 716, 1336], 267392),
    (4, 129, [182, 358, 692, 1296], 271488),
    (4, 256, [94, 186, 360, 672], 398464),
    (2, 1, [2697, 5310, 10276, 19192], 144544),
    (2, 19, [971, 1910, 3700, 6904], 160928),
    (2, 128, [188, 370, 716, 1336], 267424),
    (2, 129, [177, 348, 672, 1256], 275616),
    (2, 256, [94, 184, 356, 672], 398496)])
def test_lloyd_layout_is_the_kernels(itemsize, d, windows, at256):
    """FlashLloyd's dynamic shared memory (``csrc/flash_lloyd.cu``
    smem_bytes; chip_smoke.py reads it back from the compiled kernel at
    d = 1, 19, 128, 129 and every C): the ring (f32: 2 stages of x and c
    with their tf32 low parts, 64 KB each; bf16: 4 stages of 32 KB), 1,024
    bytes of alignment, 1,632 of barriers, id slots, row norms and
    counters, three lists of C * 128 ids, and a slice of ceil(K / C) rows
    of sums and counts at d padded to 16-byte rows (here K = 256, C = 1).
    The windows are the largest K of each cluster size."""
    assert [H.max_fused_k(d, itemsize, cl, H100) for cl in (1, 2, 4, 8)] \
        == windows
    assert H.fused_footprint(256, d, itemsize, 1) == at256
    for cl, kmax in zip((1, 2, 4, 8), windows):
        assert H.choose_lloyd_cluster(kmax, d, itemsize, H100) == cl
        assert H.fused_footprint(kmax, d, itemsize, cl) \
            <= H100.smem_block_bytes
    assert H.choose_lloyd_cluster(windows[-1] + 1, d, itemsize, H100) is None
