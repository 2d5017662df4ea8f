"""The port's exhaustive tuner and the planner's measured refinement, on
the CPU.

The tuner ports the reference's contract (``repro/core/autotune.py``,
held by ``tests/core/test_autotune.py``), not its TPU grid: the assign
kernel is timed once at its compiled tile, the sort-inverse update over
its (rows, threads) pairs. On the CPU it times the plain versions at the
reference's capped size, so the report's structure is checked here and
its numbers only on the card. ``fold_measured`` and ``refine="measure"``
are held to the reference's rules (all three legs measured, one tune per
shape bucket, the plans persisted).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import autotune
from repro_torch.core import heuristics as H
from repro_torch.core import plan as P
from repro_torch.kernels import sort_inverse_update as siu
from repro_torch.kernels.ops import BlockConfig

SHAPE = (2048, 64, 32)


def test_candidates_are_the_update_grid():
    cands = autotune.update_candidates(32, 4, torch.device("cpu"))
    rows = [64 << i for i in range(6)]
    assert rows[-1] == H.UPDATE_MAX_CHUNK and rows[0] == H.UPDATE_MIN_CHUNK
    assert cands == [(bn, bk) for bn in rows
                     for bk in range(32, siu.THREADS + 1, 32)]


def test_exhaustive_tune_report_is_well_formed():
    n, k, d = 256, 8, 16
    rep = autotune.exhaustive_tune(n, k, d, device="cpu")
    assert rep.num_compiles == len(rep.table) == 1 + len(
        autotune.update_candidates(d, 4, torch.device("cpu")))
    assert rep.tune_seconds > 0
    assert np.isfinite(rep.best_assign_us) and rep.best_assign_us > 0
    assert np.isfinite(rep.best_update_us) and rep.best_update_us > 0
    assert {kind for kind, _, _ in rep.table} == {"assign", "update"}
    assert all(us > 0 for us in rep.table.values())
    blk = rep.best.validate()
    a_key = ("assign", blk.assign_block_n, blk.assign_block_k)
    u_key = ("update", blk.update_block_n, blk.update_block_k)
    assert (blk.assign_block_n, blk.assign_block_k) == \
        (BlockConfig().assign_block_n, BlockConfig().assign_block_k)
    assert rep.table[a_key] == rep.best_assign_us
    assert rep.table[u_key] == rep.best_update_us == min(
        us for (kind, _, _), us in rep.table.items() if kind == "update")


def test_exhaustive_tune_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.exhaustive_tune(*SHAPE)


def test_heuristic_tune_is_the_planners_answer():
    rep = autotune.heuristic_tune(4096, 64, 32, hw=H.CPU)
    assert rep.num_compiles == 2 and rep.table == {}
    assert rep.best == P.KernelPlanner(H.CPU, persist=False).block_config(
        4096, 64, 32, 4)


def _fake_report(bn=128, bk=96):
    return autotune.TuneReport(
        best=BlockConfig(update_block_n=bn, update_block_k=bk),
        num_compiles=49, tune_seconds=0.1, best_assign_us=1.0,
        best_update_us=1.0, table={})


def test_fold_measured_updates_all_three_legs(tmp_path):
    path = tmp_path / "plans.json"
    pl = P.KernelPlanner(H.CPU, cache_path=path)
    pl.plan("step", SHAPE)
    step = pl.fold_measured(*SHAPE, report=_fake_report())
    assert step.source == "measured"
    assert (step.block.update_block_n, step.block.update_block_k) == (128, 96)
    # the crossover is judged again at the merged tiles
    assert step.impl == H.choose_step_impl(*SHAPE, hw=H.CPU, blk=step.block)
    for op in ("assign", "update", "step"):
        assert pl.plan(op, SHAPE).source == "measured"
    assert pl.plan("update", SHAPE).blocks == (128, 96)
    assert pl.counters()["measure_calls"] == 0      # a report was given
    b = P.KernelPlanner(H.CPU, cache_path=path)
    assert b.plan("step", SHAPE) == step
    assert b.counters()["chooser_calls"] == 0
    assert json.loads(path.read_text())["version"] == P.CACHE_VERSION


def test_refine_measure_tunes_once(monkeypatch):
    calls = []

    def fake_tune(n, k, d, **kw):
        calls.append((n, k, d, kw["device"]))
        return _fake_report()

    monkeypatch.setattr(autotune, "exhaustive_tune", fake_tune)
    pl = P.KernelPlanner(H.CPU, persist=False)
    p1 = pl.plan("assign", SHAPE, refine="measure")
    assert p1.source == "measured" and p1.op == "assign"
    assert calls == [(*SHAPE, torch.device("cpu"))]
    assert pl.plan("assign", SHAPE, refine="measure") == p1
    assert pl.plan("update", SHAPE, refine="measure").blocks == (128, 96)
    assert pl.plan("step", SHAPE, refine="measure").source == "measured"
    assert len(calls) == 1 and pl.counters()["measure_calls"] == 1
    # another bucket tunes again; "heuristic" never tunes
    pl.plan("step", (8192, 64, 32), refine="heuristic")
    assert len(calls) == 1
    pl.plan("step", (8192, 64, 32), refine="measure")
    assert len(calls) == 2


def test_fold_measured_runs_the_tuner_on_the_planners_device():
    pl = P.KernelPlanner(H.CPU, persist=False)
    step = pl.fold_measured(*SHAPE)
    assert pl.counters()["measure_calls"] == 1
    assert step.source == "measured"
    cands = autotune.update_candidates(SHAPE[2], 4, torch.device("cpu"))
    assert (step.block.update_block_n, step.block.update_block_k) in cands
