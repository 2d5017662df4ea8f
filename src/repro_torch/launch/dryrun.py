"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on meta
tensors over a fake production mesh, and record what one rank executes.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell on 512 forced host devices and reads flops, bytes and collectives
from the optimized HLO. The port has no HLO: in one process it starts a
fake world (``torch.distributed``'s ``"fake"`` backend: every collective
is a no-op, so no peer exists) of the mesh's size, places the parameters,
the optimizer state and the inputs on the meta device as DTensors (shapes
only, nothing allocated), runs the step itself, and counts the ops rank 0
executes (``launch.op_cost``): its local flops and bytes, the collectives
DTensor issues for it, and the peak of the storage it allocates.

The record has the reference's keys, key for key. ``lower_s`` is the
seconds from the abstract state to the step's end. Keys with no
counterpart are null: ``compile_s`` (nothing is compiled),
``xla_cost_flops`` and ``xla_cost_bytes`` (no XLA cost analysis), and
``memory_analysis.generated_code_bytes``. ``memory_analysis``'s
``argument_bytes`` and ``output_bytes`` are rank 0's local bytes of the
step's arguments and results; ``temp_bytes`` the peak of the storage the
step allocated and still held. The per-op table goes to
``{arch}__{shape}__{tag}.ops.json.gz`` in place of the reference's
``.hlo.gz``; ``--reanalyze`` re-derives the counted keys from it.

The mesh is a ``"cpu"`` DeviceMesh by default; ``--mesh-device cuda``
builds a ``"cuda"`` one (a card must be visible; the tensors stay on
meta). On a ``"cpu"`` mesh DTensor runs an all-to-all as an all-gather
and a chunk; the counter counts it as the all-to-all a CUDA mesh issues.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all            # sweep, one subprocess/cell
  python -m repro_torch.launch.dryrun --reanalyze      # re-read the op tables
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, all_configs, get_config
from repro_torch.launch import op_cost, roofline
from repro_torch.launch import specs as SP
from repro_torch.core.parallel import init_fake_world, make_production_mesh
from repro_torch.train.train_step import make_serve_step, make_train_step
from repro_torch.utils import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_map

OUT_DIR = "results/dryrun_torch"


def cell_skipped(cfg, shape_name: str) -> str | None:
    for name, why in cfg.skip_shapes:
        if name == shape_name:
            return why
    return None


def _tag(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}__"
                                 f"{_tag(record['multi_pod'])}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tree of tensors (a DTensor's local piece)."""
    return sum(shd.local_part(t).nbytes for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _place(tree, pl_tree, mesh):
    return tree_map(lambda t, pl: shd.place(t, mesh, pl), tree, pl_tree)


def _meta_batch(cfg, shape, mesh) -> dict:
    batch, pls = SP.train_batch_specs(cfg, shape, mesh)
    return {k: shd.place(torch.empty(s, dtype=dt, device="meta"), mesh,
                         pls[k]) for k, (s, dt) in batch.items()}


def _counted_keys(c: dict) -> dict:
    """The record's counted keys from ``op_cost.analyze``'s totals."""
    return dict(flops_per_device=c["flops"],
                hbm_bytes_per_device=c["hbm_bytes"],
                collective_counts=c["collective_counts"],
                collective_wire_bytes=c["collective_wire_bytes"],
                wire_bytes_total=c["wire_bytes"])


def _roofline(c: dict, chips: int) -> dict:
    return roofline.roofline_terms(c["flops"], c["hbm_bytes"],
                                   c["wire_bytes"], chips)


# an ok record's keys, the reference's (``decode_mode``: decode cells only)
OK_KEYS = ("arch", "shape", "multi_pod", "chips", "status", "decode_mode",
           "lower_s", "compile_s", "flops_per_device",
           "hbm_bytes_per_device", "collective_counts",
           "collective_wire_bytes", "wire_bytes_total", "xla_cost_flops",
           "xla_cost_bytes", "memory_analysis", "roofline", "tokens_global",
           "model_flops_global", "model_flops_per_device",
           "useful_flops_ratio")


def measure(cfg, shape, mesh, record: dict) -> op_cost.OpCounter:
    """Run ``cfg``'s step at ``shape`` once on meta tensors over ``mesh``
    under an ``OpCounter`` and write the ok record's keys into ``record``
    (raises where the step does). Returns the counter."""
    chips = mesh.size()
    t0 = time.time()
    counter = op_cost.OpCounter()
    # serving cells hold bf16 weights (no optimizer state); training cells
    # keep f32 masters, as the reference's
    params, params_pl, opt, opt_pl = SP.abstract_state(
        cfg, mesh,
        params_dtype=torch.bfloat16 if shape.kind == "decode" else None)
    params = _place(params, params_pl, mesh)
    if shape.kind in ("train", "prefill"):
        # prefill_32k runs as a train step at the prefill shape, as the
        # reference lowers it
        opt = _place(opt, opt_pl, mesh)
        batch = _meta_batch(cfg, shape, mesh)
        args = (params, opt, batch)
        step = make_train_step(cfg, mesh, remat=True)
        with counter:
            out = step(params, opt, batch, 0)
    else:
        mode = SP.decode_mode_for(cfg, shape)
        record["decode_mode"] = mode
        token, token_pl, caches, caches_pl, cross, cross_pl = \
            SP.decode_inputs_specs(cfg, shape, mesh, mode=mode)
        token = shd.place(token, mesh, token_pl)
        caches = _place(caches, caches_pl, mesh)
        if cross is not None:
            cross = _place(cross, cross_pl, mesh)
        args = (params, token, caches, cross)
        step = make_serve_step(cfg, mesh)
        with counter:
            out = step(params, token, caches, cross)
    t_lower = time.time() - t0
    try:
        mem_rec = {"argument_bytes": local_bytes(args),
                   "output_bytes": local_bytes(out),
                   "temp_bytes": counter.peak_bytes,
                   "generated_code_bytes": None}
    except Exception as e:
        mem_rec = {"error": str(e)}

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = 6.0 * cfg.n_active_params() * tokens
    if shape.kind == "decode":
        model_flops = 2.0 * cfg.n_active_params() * tokens
    c = counter.analyze()
    record.update(
        status="ok",
        lower_s=round(t_lower, 2),
        compile_s=None,
        **_counted_keys(c),
        xla_cost_flops=None,
        xla_cost_bytes=None,
        memory_analysis=mem_rec,
        roofline=_roofline(c, chips),
        tokens_global=tokens,
        model_flops_global=model_flops,
        model_flops_per_device=model_flops / chips,
        useful_flops_ratio=(model_flops / chips) / c["flops"] if c["flops"]
        else None)
    return counter


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = OUT_DIR, mesh_device: str = "cpu") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    why = cell_skipped(cfg, shape_name)
    if why:
        record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                  "status": "skipped", "reason": why}
        _write(record, out_dir)
        return record

    chips = 512 if multi_pod else 256
    init_fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=mesh_device)
    record = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "chips": chips, "status": "error"}
    try:
        counter = measure(cfg, shape, mesh, record)
        os.makedirs(out_dir, exist_ok=True)
        op_cost.save_table(counter.table, os.path.join(
            out_dir, f"{arch}__{shape_name}__{_tag(multi_pod)}.ops.json.gz"))
    except Exception as e:
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()

    _write(record, out_dir)
    return record


def _env() -> dict:
    """The environment of a sweep's subprocess: this package importable."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return env


def sweep(out_dir: str, force: bool = False,
          mesh_device: str = "cpu") -> None:
    """Run every cell in a fresh subprocess (bounded memory, isolation)."""
    cells = [(arch, shape, mp) for arch in sorted(all_configs())
             for shape in SHAPES for mp in (False, True)]
    for arch, shape, mp in cells:
        tag = _tag(mp)
        path = os.path.join(out_dir, f"{arch}__{shape}__{tag}.json")
        if os.path.exists(path) and not force:
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"[cached] {arch} {shape} {tag}")
                    continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out_dir, "--mesh-device",
               mesh_device]
        if mp:
            cmd.append("--multi-pod")
        print(f"[run] {arch} {shape} {tag}", flush=True)
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True, env=_env())
        dt = time.time() - t0
        status = "?"
        if os.path.exists(path):
            with open(path) as f:
                status = json.load(f).get("status")
        print(f"      -> {status} in {dt:.0f}s", flush=True)
        if r.returncode != 0 and status != "ok":
            print(r.stderr[-2000:], flush=True)


def reanalyze(out_dir: str) -> None:
    """Recompute the counted keys and the roofline terms from the saved op
    tables (nothing is run again)."""
    for path in sorted(glob.glob(os.path.join(out_dir, "*.ops.json.gz"))):
        base = path[:-len(".ops.json.gz")]
        jpath = base + ".json"
        if not os.path.exists(jpath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        c = op_cost.analyze(op_cost.load_table(path))
        rec.update(_counted_keys(c), roofline=_roofline(c, rec["chips"]),
                   useful_flops_ratio=(rec["model_flops_per_device"] /
                                       c["flops"] if c["flops"] else None))
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        print(f"[reanalyzed] {os.path.basename(base)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--mesh-device", choices=("cpu", "cuda"), default="cpu",
                    help="the DeviceMesh's device type (tensors stay on "
                         "meta)")
    args = ap.parse_args(argv)

    if args.reanalyze:
        reanalyze(args.out)
        return
    if args.all:
        sweep(args.out, force=args.force, mesh_device=args.mesh_device)
        return
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   out_dir=args.out, mesh_device=args.mesh_device)
    slim = {k: v for k, v in rec.items() if k != "traceback"}
    print(json.dumps(slim, indent=1, default=str))
    if rec.get("status") == "error":
        print(rec.get("traceback", ""), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
