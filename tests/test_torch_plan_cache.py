"""The port's on-disk plan cache (``KernelPlanner(cache_path=,
persist=)``), on the CPU, beside the JAX package's.

The file has the reference's format (``CACHE_VERSION``), so one file can
hold both packages' entries: the port uses only its own entries made on
its hardware row by its build of ``csrc/`` and writes every other entry
back verbatim; the JAX package's loader reads a file the port wrote
without failing. Every test writes under ``tmp_path``.
"""
import json

import pytest

from repro.core import heuristics as JH
from repro.core import plan as JP
from repro_torch.core import heuristics as H
from repro_torch.core import plan as P
from repro_torch.kernels import _build

STEP = (65536, 512, 64)
PROBE = (1024, 512, 64, 8)
OTHER_CARD = H.hopper_row("h100_other", num_sms=114, l2_bytes=50 * 2**20,
                          smem_block_bytes=232_448)


def planner(path=None, hw=H.CPU, **kw):
    return P.KernelPlanner(hw, cache_path=path,
                           persist=path is not None, **kw)


def test_round_trip_serves_plans_with_no_chooser_call(tmp_path):
    path = tmp_path / "plans.json"
    a = planner(path)
    pa = (a.plan("step", STEP), a.plan("probe", PROBE),
          a.plan("scan_store", (256, 16, 300, 128, 10)))
    assert path.exists()
    b = planner(path)
    pb = (b.plan("step", STEP), b.plan("probe", PROBE),
          b.plan("scan_store", (256, 16, 300, 128, 10)))
    assert pb == pa
    c = b.counters()
    assert c["chooser_calls"] == 0 and c["disk_entries_loaded"] >= 3
    assert c["measure_calls"] == 0
    raw = json.loads(path.read_text())
    assert raw["version"] == P.CACHE_VERSION
    assert all(e["package"] == "repro_torch"
               and e["build"] == _build.source_hash()
               for e in raw["plans"].values())


def test_corrupt_file_is_replanned_and_replaced(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text("{not json at all")
    pl = planner(path)
    p = pl.plan("step", STEP)                       # must not raise
    assert pl.counters()["chooser_calls"] == 1
    assert json.loads(path.read_text())["version"] == P.CACHE_VERSION
    assert planner(path).plan("step", STEP) == p


def test_stale_version_is_ignored(tmp_path):
    path = tmp_path / "plans.json"
    planner(path).plan("step", STEP)
    raw = json.loads(path.read_text())
    raw["version"] = P.CACHE_VERSION - 1
    path.write_text(json.dumps(raw))
    b = planner(path)
    b.plan("step", STEP)
    assert b.counters()["disk_entries_loaded"] == 0
    assert b.counters()["chooser_calls"] == 1
    assert json.loads(path.read_text())["version"] == P.CACHE_VERSION


def test_bad_entry_is_skipped_and_dropped(tmp_path):
    path = tmp_path / "plans.json"
    planner(path).plan("step", STEP)
    raw = json.loads(path.read_text())
    key = next(iter(raw["plans"]))
    raw["plans"][key] = {"package": "repro_torch", "garbage": True}
    path.write_text(json.dumps(raw))
    b = planner(path)
    b.plan("probe", PROBE)                          # must not raise
    assert b.counters()["disk_entries_loaded"] == len(raw["plans"]) - 1
    assert key not in json.loads(path.read_text())["plans"]


def test_mixed_file_keeps_other_entries_verbatim(tmp_path):
    """A file the JAX package wrote, plus another card's entries: the port
    writes both back unchanged, uses neither, and the JAX loader still
    reads its own plans from the merged file."""
    path = tmp_path / "plans.json"
    jp = JP.KernelPlanner(hw=JH.TPU_V5E, cache_path=path)
    jplan = jp.plan("step", STEP)
    planner(path, hw=OTHER_CARD).plan("step", STEP)
    before = json.loads(path.read_text())["plans"]
    mine = planner(path)
    mine.plan("step", STEP)
    assert mine.counters()["disk_entries_loaded"] == 0
    assert mine.counters()["chooser_calls"] == 1
    after = json.loads(path.read_text())["plans"]
    for key, entry in before.items():
        assert after[key] == entry                  # verbatim
    assert len(after) > len(before)
    j2 = JP.KernelPlanner(hw=JH.TPU_V5E, cache_path=path)
    assert j2.plan("step", STEP) == jplan
    assert j2.counters()["chooser_calls"] == 0
    other = planner(path, hw=OTHER_CARD)
    other.plan("step", STEP)
    assert other.counters()["chooser_calls"] == 0


def test_another_builds_plans_are_ignored(tmp_path, monkeypatch):
    """A plan is valid only for the kernels it was made for."""
    path = tmp_path / "plans.json"
    planner(path).plan("step", STEP)
    monkeypatch.setattr(_build, "source_hash", lambda: "another-build")
    b = planner(path)
    b.plan("step", STEP)
    assert b.counters()["disk_entries_loaded"] == 0
    assert b.counters()["chooser_calls"] == 1
    entries = json.loads(path.read_text())["plans"].values()
    assert {e["build"] for e in entries} == {"another-build"}


def test_environment_names_the_file(tmp_path, monkeypatch):
    path = tmp_path / "env" / "plans.json"
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(path))
    pl = P.KernelPlanner(H.CPU)
    assert pl.cache_path == str(path)
    pl.plan("step", STEP)
    assert path.exists()
    monkeypatch.setenv("REPRO_PLAN_CACHE", "off")
    assert P.KernelPlanner(H.CPU).cache_path is None
    monkeypatch.delenv("REPRO_PLAN_CACHE")
    assert P.KernelPlanner(H.CPU).cache_path.endswith(
        "flash_kmeans_torch/plans.json")
    assert P.KernelPlanner(H.CPU, persist=False).cache_path is None


def test_clear_forgets_and_deletes(tmp_path):
    path = tmp_path / "plans.json"
    pl = planner(path)
    pl.plan("step", STEP)
    pl.clear()
    assert path.exists() and pl.counters()["entries"] == 0
    pl.plan("step", STEP)
    assert pl.counters()["disk_entries_loaded"] >= 1
    pl.clear(disk=True)
    assert not path.exists()
    pl.clear(disk=True)                             # nothing left: no error


def test_plan_to_dict_round_trip():
    pl = planner()
    for op, shape in (("step", STEP), ("probe", PROBE),
                      ("scan_q8_store", (256, 16, 300, 128, 10))):
        p = pl.plan(op, shape)
        assert P.KernelPlan.from_dict(json.loads(json.dumps(p.to_dict()))) \
            == p


def test_unknown_refine_raises():
    with pytest.raises(ValueError, match="refine"):
        planner().plan("step", STEP, refine="guess")
