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


def fused_smem_bytes(k, d):
    """FlashLloyd's shared memory at its compiled 64 x 64 tiles."""
    return H.fused_footprint(64, 64, d, 4, k)


H100 = H.hopper_row("h100_test", num_sms=132, l2_bytes=50 * 2**20,
                    smem_block_bytes=232_448)
# a row whose tensor cores run no faster than its CUDA cores: FlashAssign and
# FlashLloyd then share one flop rate and only bytes and shared memory decide
CUDA_CORES = dataclasses.replace(H100, flops_tf32=3 * H100.flops_f32,
                                 flops_bf16=H100.flops_f32)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_paper_regimes_plan_as_expected(itemsize):
    # FlashAssign's tensor-core argmin (3xTF32 / bf16) plus the sort-inverse
    # bytes beat FlashLloyd's CUDA-core argmin at all four regimes
    planner = P.KernelPlanner(H100)
    assert planner.plan("step", (65536, 256, 128),
                        itemsize).impl == "two_pass"
    assert planner.plan("step", (8388608, 1024, 128),
                        itemsize).impl == "two_pass"
    assert planner.plan("step", (65536, 1024, 128), itemsize).impl == \
        "two_pass"
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
                assert fused_smem_bytes(k, d) <= H100.smem_block_bytes
                assert p.smem_bytes == fused_smem_bytes(k, d)


def test_fused_window_is_the_shared_memory_bound():
    kmax = H.max_fused_k(128, H100)
    assert 400 <= kmax <= 450
    assert fused_smem_bytes(kmax, 128) <= H100.smem_block_bytes
    assert fused_smem_bytes(kmax + 1, 128) > H100.smem_block_bytes
    assert H.choose_step_impl(65536, kmax, 128, hw=CUDA_CORES) == "fused"
    assert H.choose_step_impl(65536, kmax + 1, 128,
                              hw=CUDA_CORES) == "two_pass"
    # 4 (K d + K) dynamic bytes on top of the kernel's 9,248 static ones
    # (chip_smoke.py checks the static size against the compiled kernel)
    assert fused_smem_bytes(256, 128) == 4 * (256 * 128 + 256) + 9248


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
    slow_mem = dataclasses.replace(CUDA_CORES, hbm_bw=1e9)
    # with a starved memory system the per-CTA accumulator flush dominates
    # a tiny problem and the fused path stops winning
    assert H.choose_step_impl(256, 400, 128, hw=CUDA_CORES) == "fused"
    assert H.choose_step_impl(256, 400, 128, hw=slow_mem) == "two_pass"
    # the assign leg runs at the row's TF32 (f32, three products) and bf16
    # tensor-core rates
    for itemsize in (4, 2):
        assert H.choose_step_impl(65536, 256, 128, dtype_bytes=itemsize,
                                  hw=H100) == "two_pass"
        assert H.choose_step_impl(65536, 256, 128, dtype_bytes=itemsize,
                                  hw=CUDA_CORES) == "fused"
    assert H.assign_flops_rate(4, H100) == H100.flops_tf32 / 3
    assert H.assign_flops_rate(2, H100) == H100.flops_bf16


@pytest.mark.parametrize("itemsize,k_cross", [(4, 82), (2, 42)])
def test_fused_two_pass_crossover(itemsize, k_cross):
    """The roofline crossover at N = 65,536, d = 128: FlashLloyd's CUDA-core
    argmin, ``2 N K d / 67e12``, against the tensor-core argmin
    (``3 * 2 N K d / 495e12`` in f32, ``2 N K d / 989e12`` in bf16) plus the
    update's bytes, about ``(16 N + N d b) / 3.35e12``, meet at K = 82 (f32)
    and 42 (bf16)."""
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
        assert (blk.fused_block_n, blk.fused_block_k) == (64, 64)
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
    x, c = torch.randn(64, 128), torch.randn(1024, 128)
    with pytest.raises(ValueError, match="shared-memory limit"):
        ops.flash_lloyd_step(x, c)
    with pytest.raises(ValueError, match="compiled"):
        ops.flash_lloyd_step(x, c[:8], block_n=128, block_k=64)
