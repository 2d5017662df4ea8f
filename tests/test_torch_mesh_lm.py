"""The LM path's training over a mesh, on 4 gloo ranks of the CPU, held
to the JAX package's one-device step on the same numpy inputs.

One group of 4 ranks runs per module (``tests/_torch_mesh_lm_worker.py
... train``, which imports ``repro_torch`` only), on meshes 2x2, 1x4 and
4x1 of ``data x model``: two ``make_train_step(mesh=)`` AdamW steps (f32,
a constant learning rate) of the reduced dense GQA (remat on), MoE (on
1x4, and on 2x2 with its groups split over data), MLA (remat on) and
starcoder2 configs, of whisper-base with 3 heads on a model axis of 2, and
of llama3-8b with the routed attention, against ``jax.jit`` of the reference's ``make_train_step`` on
one device: the loss, NLL and grad norm each step within rtol 1e-4 (atol
1e-6, as ``tests/test_torch_train_step.py``), the params' and the first
moments' global norms of the difference within 1e-4 of theirs (the routed
variant's moments element by element at ``tests/test_torch_train_routed``'s
rtol 1e-4, atol 1e-5), and every leaf of the params and moments at the
placements its resolved spec names after the steps. The routed fits start
from the JAX draw, whose rows depend on the length and count alone, and
every rank's routing ids at the first step equal the one-device loss's. A
checkpoint saved on 2x2 restores onto 1x4 and onto one rank bit for bit,
and a rank that keeps no host copy holds one gathered leaf at a time while
it saves; ``launch/train.py --mesh 2x2 --reduced`` runs on 4 ranks under a
``torchrun``-like environment (``tests/test_torch_mesh_lm_serve.py`` holds
the serving half).
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_train_common import jax_draws, models, torchrun
from repro.optim import adamw as jadamw
from repro.train import train_step as jts

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_mesh_lm_worker as W  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
W_RANKS = 4
B, S = 4, 32
NAMES = [c[0] for c in W.TRAIN]


def _batches(cfg, name):
    rng = np.random.default_rng(NAMES.index(name) + 3)
    s = 64 if name == "routed" else S
    out = []
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[:, -1] = -1
        b = {"tokens": tok, "labels": lab}
        if cfg.frontend:
            b["frontend"] = rng.standard_normal(
                (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, batches = {}, {}
    for name, arch, rep, _, _ in W.TRAIN:
        jcfg, _, _, npp = models(arch, **rep)
        params[name] = npp
        batches[name] = _batches(jcfg, name)
    inp = {"params": params, "batches": batches, "draws": jax_draws((64,))}
    return inp, W.run_ranks(tmp_path_factory.mktemp("mesh_lm"), "train",
                            inp)

def _jax_steps(name, arch, rep, remat, batches):
    jcfg, _, jp, _ = models(arch, **rep)
    step = jax.jit(jts.make_train_step(
        jcfg, None, compute_dtype=jnp.float32, remat=remat,
        lr_schedule=lambda s: W.LR))
    jo = jadamw.init(jp)
    metrics = []
    for i, b in enumerate(batches):
        jp, jo, jm = step(jp, jo, {k: jnp.asarray(v) for k, v in b.items()},
                          jnp.int32(i))
        metrics.append({k: float(v) for k, v in jm.items()})
    return metrics, jax.tree_util.tree_leaves(jp), \
        jax.tree_util.tree_leaves(jo["m"])


def _rel_norm(got, want):
    num = sum(float(np.sum((np.asarray(g, np.float64)
                            - np.asarray(w, np.float64)) ** 2))
              for g, w in zip(got, want))
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", W.TRAIN, ids=NAMES)
def test_train_steps_on_the_mesh_match_the_jax_step(ranks, case):
    inp, res = ranks
    name, arch, rep, _, remat = case
    metrics, jparams, jm = _jax_steps(name, arch, rep, remat,
                                      inp["batches"][name])
    got = res[0][f"train/{name}"]
    for g, w in zip(got["metrics"], metrics):
        for k in ("loss", "nll", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} {k}")
    assert len(got["params"]) == len(jparams)
    assert _rel_norm(got["params"], jparams) < RTOL
    if name == "routed":
        for g, w in zip(got["m"], jm):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
    else:
        assert _rel_norm(got["m"], jm) < RTOL


def test_the_routed_ids_on_the_mesh_are_one_devices(ranks):
    """On tie-free data every rank's routed fits (its own sequences and
    heads) give the one-device loss's ids at the first step."""
    _, res = ranks
    assert [r["train/routed"]["ids_differ"] for r in res] == [0] * W_RANKS


@pytest.mark.parametrize("case", W.TRAIN, ids=NAMES)
def test_every_leaf_keeps_its_resolved_placements(ranks, case):
    _, res = ranks
    assert all(r[f"train/{case[0]}"]["placed"] for r in res)


def test_every_rank_holds_the_same_metrics(ranks):
    _, res = ranks
    for name in NAMES:
        assert all(r[f"train/{name}"]["metrics"]
                   == res[0][f"train/{name}"]["metrics"] for r in res[1:])


@pytest.mark.parametrize("what", ["mesh_bits", "mesh_placed", "one_bits",
                                  "one_plain", "one_leaf_at_a_time"])
def test_checkpoint_reshards_bit_for_bit(ranks, what):
    _, res = ranks
    assert all(r["ckpt"][what] for r in res)


# --- the launcher under torchrun's environment ---------------------------

def test_launcher_trains_on_a_2x2_mesh(tmp_path):
    """``launch/train.py --mesh 2x2`` on 4 ranks: the same losses on every
    rank, the one-device launcher's losses within rtol 1e-4, one
    checkpoint written, and only rank 0 prints."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", "llama3-8b", "--reduced", "--device", "cpu",
            "--steps", "3", "--seq", "32", "--batch", "4", "--log-every",
            "1"]
    outs, logs = torchrun(tmp_path, 4, "train", ("losses", "mesh"),
                           [*argv, "--mesh", "2x2", "--ckpt-dir",
                            str(tmp_path / "ckpt")])
    one = launch_train.main([*argv, "--ckpt-dir", str(tmp_path / "one")])
    assert all(o == outs[0] for o in outs) and outs[0]["mesh"] == [2, 2]
    np.testing.assert_allclose([v for _, v in outs[0]["losses"]],
                               [v for _, v in one["losses"]], rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["manifest.json",
                                                    "step_00000003.npz"]
    assert "loss first->last" in logs[0]
    assert all("loss first->last" not in lg for lg in logs[1:])
