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
# the largest K at which the planner takes the fused step at d = 128 and
# N = 65,536
K_CROSS_F32, K_CROSS_BF16 = 256, 1336


@pytest.mark.parametrize("itemsize", [4, 2])
def test_paper_regimes_plan_as_expected(itemsize):
    # both paths run the tensor-core argmin; at smallN_smallK FlashLloyd's
    # additions beat the update's bytes and the sort's device time; at K =
    # 1,024 its f32 re-split of the streamed x for each of 8 centroid tiles
    # costs more than they do; at N = 8,388,608 its additions cost more than
    # them in both types (FlashAssign's consumers sum ||x||^2, so the
    # two-pass step reads x twice, not four times); K = 65,536 at d = 512
    # fits no cluster
    planner = P.KernelPlanner(H100)
    f32 = itemsize == 4
    assert planner.plan("step", (65536, 256, 128), itemsize).impl == "fused"
    assert planner.plan("step", (8388608, 1024, 128),
                        itemsize).impl == "two_pass"
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
    slow_mem = dataclasses.replace(H100, hbm_bw=H100.hbm_bw / 10)
    # at largeN_smallK bf16 the two-pass step wins by the row's memory rate;
    # on a memory system ten times slower its two reads of x and the
    # update's gathered rows cost more than FlashLloyd's one read
    assert H.choose_step_impl(8388608, 1024, 128, dtype_bytes=2,
                              hw=H100) == "two_pass"
    assert H.choose_step_impl(8388608, 1024, 128, dtype_bytes=2,
                              hw=slow_mem) == "fused"
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
    """The crossover at d = 128. At N = 65,536, f32: through K = 256 (two
    centroid tiles) FlashLloyd's one re-split of the streamed x and its
    additions cost less than the update's bytes and the sort's device time
    (``sort_seconds``, mostly its floor there); from the third tile on the
    re-splits cost more. bf16 has no split: fused wherever a cluster size
    fits (K <= 1,336). At N = 8,388,608 the additions (N d values at the
    measured rate) cost more than the update and the sort: two-pass at
    every K in bf16, and in f32 outside the K at which one centroid tile's
    argmin hides them."""
    n = 65536
    assert H.choose_step_impl(n, k_cross, 128, dtype_bytes=itemsize,
                              hw=H100) == "fused"
    assert H.choose_step_impl(n, k_cross + 1, 128, dtype_bytes=itemsize,
                              hw=H100) == "two_pass"
    big = [k for k in (16, 64, 256, 257, 1024, k_cross)
           if H.choose_step_impl(8388608, k, 128, dtype_bytes=itemsize,
                                 hw=H100) == "fused"]
    assert big == []
    # the sort's model at the sizes it was fitted to and checked against
    for ids, ms in ((65536, 0.0398), (262144, 0.0497), (2097152, 0.1396),
                    (8388608, 0.4372)):
        assert abs(H.sort_seconds(ids) * 1e3 - ms) <= 0.02 * ms


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
    route = planner.plan("route", (1, 2048, 3, 4))   # the router's op
    assert route.op == "route" and route.blocks == H.choose_route_params(
        2048, 4)
    with pytest.raises(ValueError, match="unknown plan op"):
        planner.plan("paged_scan", (1, 2, 3, 4))
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


@pytest.mark.parametrize("itemsize,d", [(4, 128), (4, 3), (4, 512),
                                        (2, 128), (2, 512)])
def test_assign_footprint_with_distances_holds_the_rows_norms(itemsize, d):
    """The launch that returns distances keeps each of its 128 rows'
    ``||x||^2`` (f32) past the ring: 512 bytes more, still within the
    block's limit; the planner and the wrappers' audit take that launch."""
    plain = H.assign_footprint(128, 128, d, itemsize)
    dists = H.assign_footprint(128, 128, d, itemsize, dists=True)
    assert dists == plain + 4 * 128 <= H100.smem_block_bytes
    planner = P.KernelPlanner(H100)
    assert planner.plan("assign", (65536, 256, d), itemsize).smem_bytes \
        == dists


@pytest.mark.parametrize("b,nprobe,width,l", [
    (256, 16, 3056, 40), (256, 16, 3056, 10), (1, 16, 2128, 64),
    (3, 4, 5000, 65), (32, 64, 1021, 3000), (5, 3, 97, 30)])
def test_q8_store_plan_geometry_covers_every_slot(b, nprobe, width, l):
    """The q8 store scan: lists of at most 64 entries (two a lane) take the
    cell mode, whose splits of a pair's width slots start on multiples of
    4 slots (the scales' 16-byte copies); longer lists the list mode. The
    splits cover every slot once and the partial lists hold at least l
    entries per query."""
    from repro_torch.kernels import flash_probe as fp
    planner = P.KernelPlanner(H100)
    plan = planner.plan("scan_q8_store", (b, nprobe, width, 128, l),
                        torch.int8)
    cell = l <= fp.STORE_Q8_LIST
    assert plan.op == "scan_q8_store" and plan.itemsize == 1
    assert plan.impl == ("store_scan_q8_cell" if cell
                         else "store_scan_q8_list")
    splits, tile = plan.blocks
    assert tile == fp.TILE and plan.smem_bytes <= plan.smem_limit
    s, chunk, lp, lists = fp.store_q8_geometry(nprobe, width, 128, l, splits)
    axis = width if cell else nprobe * width
    assert s == splits and (s - 1) * chunk < axis <= s * chunk
    assert lp == min(l, chunk) and lists * lp >= l
    assert lists == (nprobe * s if cell else s)
    if cell:
        assert chunk % 4 == 0
        assert splits <= max(1, width // H.STORE_MIN_ROWS)
        assert plan.smem_bytes >= fp.store_q8_cell_smem(128)
    if (b, nprobe, width, l) == (256, 16, 3056, 40):
        # the IVF1024 q8 search: 512 units of 8 pairs at least, more than
        # the resident CTAs (2 a SM: the register cap; a CTA holds a 3-tile
        # ring of 64 rows of codes and scales and one tile's dequantized
        # rows, 57 KiB), so one split
        assert splits == 1
        assert fp.store_q8_cell_smem(128) == \
            128 + 3 * (64 * 128 + 64 * 4) + 64 * (16 * 8 + 1) * 4
        assert H.q8_store_ctas_per_sm(128, H100) == 2
    # every slot of every pair read once, at most (B bucketed: plan.shape)
    assert plan.shape[1:] == (nprobe, width, 128, l)
    assert plan.hbm_bytes == H.scan_q8_store_bytes(*plan.shape)
    assert planner.plan("scan_q8_store", (b, nprobe, width, 128, l),
                        torch.int8) is plan


def test_q8_store_tiles_hold_whole_warp_steps():
    """A q8 tile holds at most 16 KiB of codes and scales (d + 4 bytes a
    row) and 36 KiB of their dequantized rows (16 G floats and ||r||^2 a
    row); its rows are a whole number of warp steps (8 rows a group of G
    lanes, 256 / G) and of 32 (whole 16-byte groups of scales). Rows off
    the 16-code vector (the block kernel's scalar path) and past 512 codes
    take the list mode."""
    from repro_torch.kernels import flash_probe as fp
    for d in (16, 32, 48, 64, 128, 256, 512):
        rows = fp.store_q8_tile_rows(d)
        g = fp._q8_lanes(d)
        step = 256 // g
        assert rows % step == 0 and rows % 32 == 0 and rows >= step
        assert 16 * g >= d                       # one vector a lane
        assert rows * (d + 4) <= fp.STORE_TILE_BYTES or rows == max(32, step)
        assert fp.store_q8_cell_smem(d) <= H100.smem_block_bytes
        assert fp.store_q8_cell_mode(64, d)
    assert fp.store_q8_tile_rows(128) == 64 and fp._q8_lanes(128) == 8
    assert not fp.store_q8_cell_mode(65, 128)
    assert not fp.store_q8_cell_mode(10, 19)     # the block's scalar path
    assert not fp.store_q8_cell_mode(10, 528)
