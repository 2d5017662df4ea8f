"""The port's dry-run (``repro_torch.launch.dryrun``, ``op_cost``,
``roofline``) against the JAX package's (``repro/launch/dryrun.py``,
``hlo_cost.py``, ``hlo_analysis.py``), on the CPU.

- ``cell_skipped`` names the reference's skips for 10 archs x 4 shapes;
- the records' key sets (ok, skipped, error) are the reference's, read from
  ``src/repro/launch/dryrun.py`` with ``ast`` (importing it would set
  ``XLA_FLAGS`` for 512 devices);
- the wire model and ``roofline_terms`` equal ``hlo_analysis``'s on
  synthesized HLO collective lines of each kind and group size, at the
  reference's peaks;
- the counter gives the same table on real CPU tensors as on meta (a train
  step runs on meta: no mask, no host read), and counts rank 0's local mm
  on a fake mesh, not the global one of DTensor's sharding propagation; a
  loop over time that runs three steps on meta counts as all of them;
- the matmul flops of one reduced llama decode step and one train step
  (remat, bf16) equal the reference's dot flops, taken with
  ``hlo_cost``'s conventions from the same step compiled for one CPU device
  (tolerance 1% decode, 10% train: XLA may fuse or CSE a recomputed
  matmul; equal on this tree);
- rank 0's argument bytes on fake 2x2 and 16x16 meshes equal the local
  shards that ``model_specs`` (and the batch and cache specs) resolve to;
- the collective counts of a 2x2 reduced train step equal
  ``CommDebugMode``'s, a cpu mesh's all-gather stand-in counted as one
  all-to-all, and a Shard->Shard redistribute is one all-to-all;
- whisper-base train_4k on the fake 16x16 mesh is ``ok`` (its 8 heads on a
  model axis of 16), through the CLI, followed by ``--reanalyze``.

Every fake world runs in a subprocess (``tests/_torch_dryrun_worker.py``
and the CLI): the xdist workers are shared.
"""
import ast
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_train_common import models
from repro.configs import base as jbase
from repro.launch import hlo_analysis, hlo_cost
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun, op_cost, roofline
from repro_torch.launch import specs as SP
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.train import train_step as tts
from repro_torch.utils import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro" / "launch" / "dryrun.py"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The worker and the CLI cell, started together."""
    out = tmp_path_factory.mktemp("dryrun")
    worker = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_worker.py"),
         str(out)], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-base", "--shape", "train_4k", "--out", str(out / "cli")],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield out, worker, cli
    for p in (worker, cli):
        if p.poll() is None:
            p.kill()


def _wait(p, timeout=300):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, (out or "")[-3000:] + (err or "")[-3000:]
    return out


@pytest.fixture(scope="module")
def worker(procs):
    out, p, _ = procs
    _wait(p)
    with open(out / "worker.json") as f:
        return json.load(f)


# --- skips and record keys ---------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jbase.all_configs()))
def test_cell_skipped_is_the_references(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for shape in jbase.SHAPES:
        want = next((why for name, why in jcfg.skip_shapes
                     if name == shape), None)
        assert dryrun.cell_skipped(tcfg, shape) == want
    assert list(tbase.SHAPES) == list(jbase.SHAPES)


def _reference_keys():
    """(skipped, ok, error, memory_analysis) key sets of the reference's
    ``run_cell`` records."""
    fn = next(n for n in ast.parse(REF.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    dicts, update, subs, mem = {}, set(), set(), None
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if isinstance(node.value, ast.Dict) and isinstance(tgt, ast.Name):
                keys = [k.value for k in node.value.keys]
                if tgt.id == "record":
                    status = node.value.values[keys.index("status")].value
                    dicts[status] = set(keys)
                elif tgt.id == "mem_rec" and "error" not in keys:
                    mem = set(keys)
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "record":
                subs.add(tgt.slice.value)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and \
                getattr(node.func.value, "id", None) == "record":
            update |= {k.arg for k in node.keywords}
    assert subs == {"decode_mode", "error", "traceback"}
    return (dicts["skipped"], dicts["error"] | update | {"decode_mode"},
            dicts["error"] | subs, mem)


def test_record_keys_are_the_references(worker):
    skipped, ok, error, mem = _reference_keys()
    assert set(worker["skipped"]) == skipped
    assert worker["skipped"]["status"] == "skipped"
    assert set(worker["ok"]) == ok == set(dryrun.OK_KEYS)   # a decode cell
    assert worker["ok"]["status"] == "ok"
    assert set(worker["ok"]["memory_analysis"]) == mem
    assert set(worker["error"]) == error
    assert worker["error"]["error"] == "RuntimeError: no serve step"
    for k in ("compile_s", "xla_cost_flops", "xla_cost_bytes"):
        assert worker["ok"][k] is None
    assert worker["ok"]["memory_analysis"]["generated_code_bytes"] is None
    assert "512" in worker["other_world"]


# --- the wire model and the roofline ---------------------------------------

_LINES = {
    "all-reduce": "%r = f32[{n}]{{0}} all-reduce(f32[{n}]{{0}} %x), "
                  "replica_groups={g}, to_apply=%add",
    "all-gather": "%r = f32[{n}]{{0}} all-gather(f32[{m}]{{0}} %x), "
                  "replica_groups={g}, dimensions={{0}}",
    "reduce-scatter": "%r = f32[{n}]{{0}} reduce-scatter(f32[{m}]{{0}} %x), "
                      "replica_groups={g}, dimensions={{0}}, to_apply=%add",
    "all-to-all": "%r = f32[{n}]{{0}} all-to-all(f32[{n}]{{0}} %x), "
                  "replica_groups={g}, dimensions={{0}}",
    "collective-permute": "%r = f32[{n}]{{0}} collective-permute("
                          "f32[{n}]{{0}} %x), source_target_pairs={{{{0,1}}}}",
}


@pytest.mark.parametrize("kind", roofline.KINDS)
@pytest.mark.parametrize("p", [2, 4, 16])
def test_wire_model_is_the_references(kind, p):
    n = 4096
    groups = "{{" + ",".join(map(str, range(p))) + "}}" if p != 16 \
        else f"[16,{p}]<=[256]"
    line = _LINES[kind].format(n=n, m=n // p, g=groups)
    stats = hlo_analysis.parse_collectives(line)
    assert stats.counts[kind] == 1
    want = stats.wire_bytes[kind]
    grp = p if kind != "collective-permute" else 2
    assert roofline.wire_bytes(kind, n * 4, grp) == pytest.approx(want,
                                                                  rel=1e-12)


def test_roofline_terms_are_the_references():
    peaks = dict(flops_peak=197e12, hbm_bw=819e9, ici_bw=50e9)
    for f, b, w in [(1e15, 1e12, 1e9), (1e12, 1e13, 1e9), (1e9, 1e9, 1e12)]:
        assert roofline.roofline_terms(f, b, w, 256, **peaks) == \
            hlo_analysis.roofline_terms(f, b, w, 256, **peaks)
    t = roofline.roofline_terms(989e12, 3.35e12, 450e9, 256)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0,
                 "bound": "compute_s"}


# --- the counter -----------------------------------------------------------

def _train_table(dev, arch="llama3-8b", s=32):
    cfg = tbase.get_config(arch).reduced()
    p = TM.init_model(cfg, device=dev, max_pos=64)
    o = adamw.init(p)
    b = {k: torch.zeros((2, s), dtype=torch.int32, device=dev)
         for k in ("tokens", "labels")}
    with op_cost.OpCounter() as c:
        tts.make_train_step(cfg, remat=True)(p, o, b, 0)
    return c.finish(), c.peak_bytes


def test_counter_on_cpu_tensors_equals_meta():
    """Flops, bytes, counts and the peak of live storage: the same for the
    step on real tensors as on meta ones."""
    (cpu, peak_cpu), (meta, peak_meta) = _train_table("cpu"), \
        _train_table("meta")
    assert cpu == meta and peak_cpu == peak_meta > 0
    assert cpu["ops"]["aten.mm"]["count"] > 0


def test_the_propagations_global_mm_is_left_out(worker):
    """2x2: a (64, 32) x (32, 48) matmul split over "data" and "model" is
    counted once, at rank 0's local (32, 32) x (32, 24), not at the global
    shape DTensor's sharding propagation runs it at."""
    assert worker["mm"]["ops"] == {"aten.mm": {
        "kind": "matmul", "count": 1, "flops": 2.0 * 32 * 32 * 24,
        "bytes": 4.0 * (32 * 32 + 32 * 24 + 32 * 24)}}
    assert worker["mm"]["collectives"] == []


def test_a_loop_over_time_on_meta_counts_as_every_step():
    """xLSTM's sLSTM recurrence over 64 steps: on meta three steps stand
    for all (``utils.loops``), counted as the CPU run's 64; the matmul
    flops equal, the rest within 1e-3 (the stacked results' gradient sums
    one middle step's results where the CPU sums each step's)."""
    (cpu, _), (meta, _) = _train_table("cpu", "xlstm-1.3b", 64), \
        _train_table("meta", "xlstm-1.3b", 64)
    a, m = op_cost.analyze(cpu), op_cost.analyze(meta)
    assert m["matmul_flops"] == a["matmul_flops"] > 0
    assert m["flops"] == pytest.approx(a["flops"], rel=1e-3)
    assert m["hbm_bytes"] == pytest.approx(a["hbm_bytes"], rel=1e-2)
    assert meta["ops"]["aten.sigmoid"] == cpu["ops"]["aten.sigmoid"]


# --- matmul flops against the reference's HLO dots -------------------------

def _dot_flops(text: str) -> float:
    """The dot flops of an optimized HLO module, loops scaled by their trip
    counts, as ``hlo_cost`` counts a ``dot``."""
    comps, entry = hlo_cost.parse_module(text)
    hc = hlo_cost.HloCost(text)
    memo = {}

    def walk(name):
        if name in memo:
            return memo[name]
        total = 0.0
        for op in comps[name].ops if name in comps else ():
            if op.kind == "while":
                m = hlo_cost._TRIP_RE.search(op.line)
                body = re.search(r"body=%?([\w.\-]+)", op.line).group(1)
                total += (int(m.group(1)) if m else 1) * walk(body)
            elif op.kind == "dot":
                total += hc._op_cost(comps[name], op).flops
            elif op.kind in ("fusion", "call", "conditional"):
                for m in hlo_cost._CALL_RE.finditer(op.line):
                    total += walk(m.group(1))
                for m in re.finditer(r"branch_computations=\{([^}]*)\}",
                                     op.line):
                    for c in m.group(1).split(","):
                        total += walk(c.strip().lstrip("%"))
        memo[name] = total
        return total
    return walk(entry)


B, S = 2, 64


def _meta_params(tcfg, dtype=None, max_pos=64):
    p = TM.init_model(tcfg, device="meta", max_pos=max_pos)
    if dtype is not None:
        p = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                     p)
    return p


@pytest.mark.parametrize("kind,rtol", [("decode", 0.01), ("train", 0.10)])
def test_matmul_flops_match_the_references_dots(kind, rtol):
    jcfg, tcfg, jp, _ = models("llama3-8b")
    counter = op_cost.OpCounter()
    if kind == "decode":
        caches = JM.init_decode_caches(jcfg, B, S, mode="dense")
        text = jax.jit(jts.make_serve_step(jcfg)).lower(
            jp, jnp.zeros((B, 1), jnp.int32), caches).compile().as_text()
        tp = _meta_params(tcfg, torch.bfloat16)
        tc = TM.init_decode_caches(tcfg, B, S, mode="dense",
                                   dtype=torch.bfloat16, device="meta")
        with counter:
            tts.make_serve_step(tcfg)(
                tp, torch.zeros((B, 1), dtype=torch.int32, device="meta"),
                tc)
    else:
        jb = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "labels")}
        text = jax.jit(jts.make_train_step(jcfg, None, remat=True)).lower(
            jp, jadamw.init(jp), jb, jnp.int32(0)).compile().as_text()
        tp = _meta_params(tcfg)
        tb = {k: torch.zeros((B, S), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
        with counter:
            tts.make_train_step(tcfg, remat=True)(tp, adamw.init(tp), tb, 0)
    want = _dot_flops(text)
    got = counter.analyze()["matmul_flops"]
    assert want > 0
    assert got == pytest.approx(want, rel=rtol)


# --- argument bytes and collectives on fake meshes -------------------------

class _Stub:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


def _local_nbytes(tree, spec_tree, mesh) -> int:
    """The local bytes of every leaf under its resolved spec, computed from
    the shapes alone."""
    resolved = shd.resolve_tree(spec_tree, tree, mesh)
    total = 0

    def one(spec, t):
        nonlocal total
        n = 1
        for size, entry in zip(t.shape, spec):
            axes = () if entry is None else (entry,) if isinstance(
                entry, str) else entry
            n *= size // math.prod(mesh.shape[a] for a in axes)
        total += n * t.element_size()
        return None
    shd.map_specs(one, resolved, tree)
    return total


def test_argument_bytes_are_the_resolved_local_shards(worker):
    # 2x2: the reduced llama's f32 params, both moments, the count and the
    # (8, 64) batch
    cfg = tbase.get_config("llama3-8b").reduced()
    mesh = _Stub(2, 2)
    params = TM.init_model(cfg, device="meta", max_pos=32768)
    specs = TM.model_specs(cfg)
    p_bytes = _local_nbytes(params, specs, mesh)
    batch = 2 * (8 // 2) * 64 * 4
    want = 3 * p_bytes + 4 + batch
    assert worker["2x2"]["record"]["memory_analysis"]["argument_bytes"] == \
        want
    # 16x16: llama3-8b decode_32k's bf16 params, the token and the caches
    cfg = tbase.get_config("llama3-8b")
    mesh = _Stub(16, 16)
    params = _meta_params(cfg, torch.bfloat16, max_pos=32768)
    shape = tbase.SHAPES["decode_32k"]
    caches = TM.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                   mode="dense", dtype=torch.bfloat16,
                                   device="meta")
    cache_specs = SP.cache_logical_specs(caches, cfg.num_kv_heads % 16 == 0)
    want = _local_nbytes(params, TM.model_specs(cfg), mesh) + \
        shape.global_batch // 16 * 4 + _local_nbytes(caches, cache_specs,
                                                     mesh)
    assert worker["ok"]["memory_analysis"]["argument_bytes"] == want
    whole = sum(t.nbytes for t in tree_leaves(params) + tree_leaves(caches))
    assert want < whole / 100


def test_collective_counts_equal_comm_debug_modes(worker):
    """2x2: the all-reduces and reduce-scatters as ``CommDebugMode``
    counts them, and its all-gathers split into the counter's all-gathers
    and the all-to-alls a cpu mesh runs as all-gathers."""
    rec, comm = worker["2x2"]["record"], worker["2x2"]["comm"]
    counts = rec["collective_counts"]
    get = lambda name: sum(v for k, v in comm.items()   # noqa: E731
                           if k.endswith(name))
    assert counts["all-reduce"] == get("all_reduce") > 0
    assert counts["reduce-scatter"] == get("reduce_scatter_tensor") > 0
    assert counts["all-gather"] + counts["all-to-all"] == \
        get("all_gather_into_tensor") + get("shard_dim_alltoall")
    assert counts["all-to-all"] > 0 and counts["collective-permute"] == 0
    assert rec["wire_bytes_total"] == pytest.approx(
        sum(rec["collective_wire_bytes"].values()))


def test_a_shard_to_shard_redistribute_is_one_all_to_all(worker):
    table = worker["shard_to_shard"]
    assert table["collectives"] == [["all-to-all", 2, 8 * 4 * 4, 1]]
    assert list(table["ops"]) == ["_dtensor.shard_dim_alltoall"]


# --- whisper-base on the production mesh, through the CLI ------------------

def test_whisper_train_4k_cli_cell_then_reanalyze(procs):
    """whisper-base train_4k on the fake 16x16 mesh (8 heads, a model axis
    of 16) is ok; ``--reanalyze`` re-derives the counted keys from the
    saved op table."""
    out, _, cli = procs
    stdout = _wait(cli)
    printed = json.loads(stdout[stdout.index("{"):])
    path = out / "cli" / "whisper-base__train_4k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == printed["status"] == "ok"
    assert set(rec) == _reference_keys()[1] - {"decode_mode"}
    assert rec["chips"] == 256 and rec["flops_per_device"] > 0
    assert (out / "cli" / "whisper-base__train_4k__single.ops.json.gz"
            ).exists()
    broken = dict(rec, flops_per_device=0.0, roofline=None,
                  wire_bytes_total=-1.0)
    path.write_text(json.dumps(broken))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--reanalyze", "--out", str(out / "cli")], env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[reanalyzed] whisper-base__train_4k__single" in r.stdout
    assert json.loads(path.read_text()) == rec
