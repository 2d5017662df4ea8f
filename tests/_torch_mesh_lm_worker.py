"""One rank of the LM path's mesh checks on the CPU (gloo).

    PYTHONPATH=src python tests/_torch_mesh_lm_worker.py RANK WORLD STORE OUT \
        train|serve

``tests/test_torch_mesh_lm.py`` (``train``) and
``tests/test_torch_mesh_lm_serve.py`` (``serve``) write the JAX package's
weights (as numpy trees), the batches and the prompts to
``OUT/inputs.pkl`` and start WORLD = 4 copies. Each rendezvouses through
the ``FileStore`` at STORE, builds the meshes of the cases below and
drives, with ``train``, ``make_train_step(mesh=)`` (two AdamW steps) and a
checkpoint saved on one mesh and restored onto another and onto one rank,
with ``serve``, the model's forward and ``Engine(mesh=).generate`` (dense
and clustered); it writes what it got to ``OUT/rank<RANK>.pkl`` (numpy
only). It imports ``repro_torch`` only; the test process holds the
results against the JAX package.
"""
from __future__ import annotations

import dataclasses
import datetime
import pickle
import sys
import weakref

LR = 1e-2

# (name, arch, config replacements, mesh, remat)
TRAIN = [
    ("dense", "llama3-8b", {}, (2, 2), True),
    ("moe", "granite-moe-1b-a400m", {}, (1, 4), False),
    ("mla", "minicpm3-4b", {}, (4, 1), True),
    ("split", "starcoder2-3b", {}, (2, 2), False),
    ("routed", "llama3-8b", {"kmeans_attn": True, "kv_cluster_k": 4},
     (2, 2), False),
    # the MoE's groups split over "data" as well as its experts over "model"
    ("moe_dp", "granite-moe-1b-a400m", {}, (2, 2), False),
    # heads the model axis does not divide (whisper-base's 8 on the
    # production mesh's 16): the merged heads' gradient keeps whole heads.
    # A data axis of 1 never reaches the fault, so 3 heads on 2x2
    ("heads", "whisper-base", {"num_heads": 3, "num_kv_heads": 3}, (2, 2),
     False),
]
# (name, arch, mesh): the dense GQA heads over the model axis, and
# starcoder2's two kv heads on a model axis of 4 (the split-KV specs)
SERVE = [("dense", "llama3-8b", (2, 2)), ("split", "starcoder2-3b", (1, 4))]
ENGINE = dict(max_seq=48, recent=4, kmeans_iters=2)
GEN = 6


def run_ranks(out, mode: str, inputs: dict, world: int = 4) -> list:
    """Write ``inputs`` to ``out``, start ``world`` ranks of ``mode``, wait
    for all (a time limit, then kill) and load each rank's results."""
    import os
    import subprocess
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(out / "store"),
         str(out), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def config(arch: str, replace: dict):
    from repro_torch.configs import base
    return dataclasses.replace(base.get_config(arch).reduced(), **replace)


def main(rank: int, world: int, store: str, out: str, mode: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core.parallel import build_mesh
    from repro_torch.data.pipeline import put_batch
    from repro_torch.models import bridge
    from repro_torch.models import kmeans_attention as kma
    from repro_torch.models import model as M
    from repro_torch.models.common import Ctx
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils import sharding as shd
    from repro_torch.utils.tree import tree_leaves, tree_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=200))
    with open(f"{out}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = build_mesh(shape, ("data", "model"),
                                       device_type="cpu")
        return meshes[shape]

    def host(tree):
        return [shd.gather(t).detach().numpy() for t in tree_leaves(tree)]

    def placed_as_specs(cfg, m, params, opt):
        want = shd.named_tree(shd.resolve_tree(M.model_specs(cfg), params,
                                               m), m)
        got = tree_map(lambda t: list(t.placements), params)
        return bool(want == got and tree_map(
            lambda t: list(t.placements), opt["m"]) == want and tree_map(
            lambda t: list(t.placements), opt["v"]) == want)

    res = {}
    # the JAX package's draw of the fits' initial rows (the routed
    # attention's and the clustered caches'): one key for every problem, so
    # the rows depend on the length and the count alone
    draws = {k: torch.from_numpy(v) for k, v in inp["draws"].items()}
    kma.initial_centroids = lambda x, kc, seed=0: x.index_select(
        1, draws[x.shape[1], kc])

    # --- training: two AdamW steps on the mesh
    for name, arch, rep, shape, remat in TRAIN if mode == "train" else ():
        cfg, m = config(arch, rep), mesh(shape)
        params = shd.place_tree(bridge.params_from_numpy(
            cfg, inp["params"][name], "cpu"), M.model_specs(cfg), m)
        opt = adamw.init(params)
        step = make_train_step(cfg, m, compute_dtype=torch.float32,
                               remat=remat, lr_schedule=lambda s: LR)
        if cfg.kmeans_attn:   # the first step's routing ids, both ways
            one = routing_ids(cfg, bridge.params_from_numpy(
                cfg, inp["params"][name], "cpu"), inp["batches"][name][0])
        metrics, fits = [], []
        for i, b in enumerate(inp["batches"][name]):
            with capture_fits(kma, fits if i == 0 else []):
                params, opt, mt = step(params, opt,
                                       put_batch(b, "cpu", mesh=m), i)
            metrics.append({k: float(v) for k, v in mt.items()})
        res[f"train/{name}"] = {"metrics": metrics, "params": host(params),
                                "m": host(opt["m"]),
                                "placed": placed_as_specs(cfg, m, params,
                                                          opt)}
        if cfg.kmeans_attn:
            # this rank's problems: sequences over "data", heads over
            # "model" where they divide them (the routed attention's split)
            split = shd.problem_split(m, dp=one[0].shape[0],
                                      tp=cfg.num_kv_heads)
            bi = m.get_local_rank("data") if split["dp"] else 0
            hi = m.get_local_rank("model") if split["tp"] else 0
            differ = 0
            for a, w in zip(fits, one):
                bl, hl = w.shape[0] // (m.size(0) if split["dp"] else 1), \
                    w.shape[1] // (m.size(1) if split["tp"] else 1)
                w = w[bi * bl:(bi + 1) * bl, hi * hl:(hi + 1) * hl]
                differ += int((a != w.reshape(a.shape)).sum())
            res[f"train/{name}"]["ids_differ"] = differ
        if name == "dense":
            res["ckpt"] = checkpoint(cfg, m, params, opt, f"{out}/ckpt")

    # --- serving: the forward's logits and Engine.generate
    for name, arch, shape in SERVE if mode == "serve" else ():
        cfg, m = config(arch, {}), mesh(shape)
        params = bridge.params_from_numpy(cfg, inp["params"][f"serve/{name}"],
                                          "cpu")
        tokens = torch.from_numpy(inp["prompts"][name])
        ctx = Ctx(compute_dtype=torch.float32, device="cpu", mesh=m)
        placed = shd.place_tree(params, M.model_specs(cfg), m)
        logits = M.forward(placed, put_batch({"tokens": inp["prompts"][name]},
                                             "cpu", mesh=m)["tokens"], ctx,
                           cfg)
        res[f"forward/{name}"] = shd.gather(logits).numpy()
        for mode in ("dense", "clustered"):
            eng = Engine(cfg, params, ServeConfig(mode=mode, **ENGINE),
                         mesh=m)
            res[f"engine/{name}/{mode}"] = eng.generate(tokens, GEN).numpy()
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


class capture_fits:
    """Records the assignments of every ``cluster_keys`` call into ``into``
    while the block runs."""

    def __init__(self, kma, into: list):
        self.kma, self.into = kma, into

    def __enter__(self):
        self.fit = self.kma.cluster_keys

        def fit(*a, **kw):
            out = self.fit(*a, **kw)
            self.into.append(out[1].detach())
            return out
        self.kma.cluster_keys = fit

    def __exit__(self, *exc):
        self.kma.cluster_keys = self.fit


def routing_ids(cfg, params, batch) -> list:
    """The one-device loss's routing ids of each layer, (B, H, S)."""
    import torch
    from repro_torch.models import kmeans_attention as kma
    from repro_torch.models import model as M
    from repro_torch.models.common import Ctx
    fits = []
    with capture_fits(kma, fits), torch.no_grad():
        M.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                  Ctx(compute_dtype=torch.float32, device="cpu"), cfg,
                  remat=False)
    b, s = batch["tokens"].shape
    return [a.reshape(b, cfg.num_heads, s) for a in fits]


def checkpoint(cfg, m, params, opt, directory: str) -> dict:
    """Save the state on ``m``, restore it onto a 1x4 mesh and onto one
    rank: every restored leaf bit for bit the saved state, gathered."""
    import numpy as np
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.launch import specs as launch_specs
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as shd
    from repro_torch.utils.tree import tree_leaves, tree_map

    state = {"params": params, "opt": opt}
    pctx = ParallelContext.for_mesh(m)
    # the whole leaves the save holds at once on a rank that keeps no host
    # copy (rank 0's host copies share the CPU tensors' memory)
    live, most, real = set(), [0], shd.gather

    def gather(t):
        w = real(t)
        if shd.is_dtensor(t):
            live.add(id(w))
            weakref.finalize(w, live.discard, id(w))
            most[0] = max(most[0], len(live))
        return w
    shd.gather = gather
    try:
        Checkpointer(directory, pctx=pctx).save(7, state)
    finally:
        shd.gather = real
    saved = [shd.gather(t).numpy() for t in tree_leaves(state)]
    other = build_mesh((1, 4), ("data", "model"), device_type="cpu")
    _, psh, _, osh = launch_specs.abstract_state(cfg, other, max_pos=64)
    like = tree_map(lambda t: shd.gather(t).detach(), state)
    onto = Checkpointer(directory, pctx=ParallelContext.for_mesh(
        other)).restore(7, like, mesh=other,
                        shardings={"params": psh, "opt": osh})
    one = Checkpointer(directory).restore(7, like)
    want = shd.named_tree(shd.resolve_tree(
        M.model_specs(cfg), like["params"], other), other)
    return {
        "mesh_bits": all(np.array_equal(shd.gather(a).numpy(), b)
                         for a, b in zip(tree_leaves(onto), saved)),
        "mesh_placed": tree_map(lambda t: list(t.placements),
                                onto["params"]) == want,
        "one_bits": all(np.array_equal(a.numpy(), b)
                        for a, b in zip(tree_leaves(one), saved)),
        "one_plain": not any(shd.is_dtensor(t) for t in tree_leaves(one)),
        "one_leaf_at_a_time": pctx.is_world_rank0 or most[0] == 1,
    }


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
