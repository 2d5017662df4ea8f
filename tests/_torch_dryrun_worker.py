"""The dry-run's fake worlds, in a process of their own.

    PYTHONPATH=src python tests/_torch_dryrun_worker.py OUT

``tests/test_torch_dryrun.py`` starts it: a fake world (``"fake"``
backend) cannot share a process with other tests. It imports
``repro_torch`` only and writes ``OUT/worker.json``:

- ``2x2``: a fake world of 4 ranks and a 2x2 ``data x model`` mesh; the
  reduced llama3-8b's train step at B 8, S 64 (``dryrun.measure``), its
  record and the table of its ops, under ``CommDebugMode`` too; the
  tables of a Shard->Shard redistribute and of a (Shard(0), Replicate) x
  (Replicate, Shard(1)) matmul;
- ``16x16``: a fake world of 256 ranks; ``run_cell`` of llama3-8b
  decode_32k (ok), whisper-base long_500k (skipped), llama3-8b decode_32k
  with a serve step that raises (error), and the ``ValueError`` of a
  multi-pod cell in a world of 256.
"""
from __future__ import annotations

import json
import os
import sys


def main(out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.core.parallel import build_mesh, init_fake_world
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.utils import sharding as shd

    torch.set_num_threads(1)
    res = {}
    init_fake_world(4)
    mesh = build_mesh((2, 2), ("data", "model"), device_type="cpu")
    cfg = get_config("llama3-8b").reduced()
    rec = {}
    with CommDebugMode() as comm:
        counter = dryrun.measure(cfg, ShapeSpec("train_small", 64, 8,
                                                "train"), mesh, rec)
    res["2x2"] = {"record": rec, "table": counter.table,
                  "comm": {str(k): v
                           for k, v in comm.get_comm_counts().items()}}
    x = shd.place(torch.empty(8, 8, device="meta"), mesh,
                  [Shard(0), Replicate()])
    with op_cost.OpCounter() as c:
        x.redistribute(mesh, [Shard(1), Replicate()])
    res["shard_to_shard"] = c.finish()
    a = shd.place(torch.empty(64, 32, device="meta"), mesh,
                  [Shard(0), Replicate()])
    b = shd.place(torch.empty(32, 48, device="meta"), mesh,
                  [Replicate(), Shard(1)])
    with op_cost.OpCounter() as c:
        a @ b
    res["mm"] = c.finish()
    dist.destroy_process_group()

    cells = os.path.join(out, "cells")
    res["ok"] = dryrun.run_cell("llama3-8b", "decode_32k", multi_pod=False,
                                out_dir=cells)
    res["skipped"] = dryrun.run_cell("whisper-base", "long_500k",
                                     multi_pod=False, out_dir=cells)

    def boom(*a, **kw):
        raise RuntimeError("no serve step")
    dryrun.make_serve_step = boom
    res["error"] = dryrun.run_cell("llama3-8b", "decode_32k",
                                   multi_pod=False,
                                   out_dir=os.path.join(out, "error"))
    try:
        dryrun.run_cell("llama3-8b", "decode_32k", multi_pod=True,
                        out_dir=cells)
        res["other_world"] = None
    except ValueError as e:
        res["other_world"] = str(e)
    dist.destroy_process_group()
    with open(os.path.join(out, "worker.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
