"""Serving the rest of the LM zoo (``repro_torch.serve.Engine``,
``launch/serve.py``) against the JAX package's ``Engine`` on the CPU, each
config reduced.

The JAX package's weights cross through ``models.bridge``; phi-3-vision's
patches and whisper's frames are the same numpy draw on both sides. Greedy
ids are compared exactly, where the JAX engine's top-two logit margin
exceeds 1e-3 at every step (asserted on the data, as in
``test_torch_lm_engine.py``). Where the clustered engine draws its initial
centroids, the port's draw is replaced by the JAX package's. Everything in
f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.init import random_init
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.models import bridge
from repro_torch.models import kmeans_attention as kma
from repro_torch.serve import Engine, ServeConfig

MARGIN = 1e-3
MAX_POS = 128
ZOO = ["granite-moe-1b-a400m", "dbrx-132b", "minicpm3-4b", "zamba2-7b",
       "xlstm-1.3b", "phi-3-vision-4.2b", "whisper-base"]
# the attention families' caches cluster and flush; MLA and xLSTM keep
# dense caches, so their clustered engine never flushes (ref. engine.py
# l.133-136)
FLUSHES = {"minicpm3-4b": 0, "xlstm-1.3b": 0}
# prompts whose greedy steps are tie-free (MARGIN) in both modes
SEEDS = {"granite-moe-1b-a400m": 24, "minicpm3-4b": 22, "zamba2-7b": 23}


def _models(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, max_pos=MAX_POS)
    tp = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    fe = (rng.normal(size=(b, cfg.frontend_seq, cfg.d_model)).astype(
        np.float32) if cfg.frontend else None)
    return tokens, fe


def _max_seq(cfg, s=32, steps=8):
    return s + steps + 8 + (cfg.frontend_seq if cfg.family == "vlm" else 0)


def _jax_generate(jcfg, jp, scfg, tokens, fe, steps):
    """The JAX engine's ids, flush count, and the smallest top-two margin
    of every logit row it sampled from."""
    eng = JEngine(jcfg, jp, JServeConfig(**dataclasses.asdict(scfg)))
    margins = []

    def record(fn, at):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            top2 = jnp.sort(out[0][:, at], axis=-1)[:, -2:]
            margins.append(float(jnp.min(top2[:, 1] - top2[:, 0])))
            return out
        return wrapped

    eng._prefill = record(eng._prefill, -1)
    eng._decode = record(eng._decode, 0)
    ids = eng.generate(jnp.asarray(tokens), steps,
                       frontend=None if fe is None else jnp.asarray(fe))
    return np.asarray(ids), eng.recluster_count, min(margins)


def _jax_rows(monkeypatch):
    """The port's initial centroid draw replaced by the JAX package's rows
    of one ``PRNGKey(0)``."""
    def rows(x, kc, *, seed=0):
        idx = random_init(jax.random.PRNGKey(seed),
                          jnp.arange(x.shape[1], dtype=jnp.float32)[:, None],
                          kc)
        return x.index_select(1, torch.from_numpy(
            np.asarray(idx)[:, 0].astype(np.int64)))
    monkeypatch.setattr(kma, "initial_centroids", rows)


@pytest.mark.parametrize("mode", ["dense", "clustered"])
@pytest.mark.parametrize("arch", ZOO)
def test_greedy_ids_equal_the_jax_engine(arch, mode, monkeypatch):
    """B 2, prompt 32 (and the frontend), 8 steps, ``recent`` 4: the ids
    and the flush count of the JAX engine."""
    _jax_rows(monkeypatch)
    jcfg, tcfg, jp, tp = _models(arch)
    tokens, fe = _inputs(jcfg, SEEDS.get(arch, 21))
    scfg = ServeConfig(max_seq=_max_seq(jcfg), mode=mode, recent=4)
    want, jcount, margin = _jax_generate(jcfg, jp, scfg, tokens, fe, 8)
    assert margin > MARGIN, f"near-tie data (margin {margin})"
    eng = Engine(tcfg, tp, scfg)
    got = eng.generate(torch.from_numpy(tokens), 8,
                       frontend=None if fe is None else torch.from_numpy(fe))
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    flushes = FLUSHES.get(arch, 2) if mode == "clustered" else 0
    assert eng.recluster_count == jcount == flushes


def test_zamba2_clustered_with_every_cluster_equals_dense():
    """zamba2's shared block reads every cluster (top = kc = 4 at a prompt
    of 32, every row within the capacity): its greedy ids are the dense
    engine's, through two flushes."""
    jcfg, tcfg, jp, tp = _models("zamba2-7b", kv_cluster_top=4)
    tokens, _ = _inputs(jcfg, 22)
    dense = ServeConfig(max_seq=48, mode="dense")
    want, _, margin = _jax_generate(jcfg, jp, dense, tokens, None, 8)
    assert margin > MARGIN, f"near-tie data (margin {margin})"
    assert np.array_equal(Engine(tcfg, tp, dense).generate(
        torch.from_numpy(tokens), 8).numpy(), want)
    eng = Engine(tcfg, tp, ServeConfig(max_seq=48, mode="clustered",
                                       recent=4))
    got = eng.generate(torch.from_numpy(tokens), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.recluster_count == 2


@pytest.mark.parametrize("arch,mode", [("granite-moe-1b-a400m", "clustered"),
                                       ("minicpm3-4b", "clustered"),
                                       ("xlstm-1.3b", "dense"),
                                       ("zamba2-7b", "clustered"),
                                       ("phi-3-vision-4.2b", "clustered"),
                                       ("whisper-base", "dense")])
def test_launcher_serves_each_family_on_the_cpu(arch, mode, capsys):
    """One config a family (moe, MLA, ssm, hybrid, vlm, audio); the vlm and
    audio inputs drawn from the seed."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--mode", mode,
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "32", "--gen", "6", "--recent", "4"])
    text = capsys.readouterr().out
    assert f"mode={mode} batch=2 prompt=32 gen=6" in text
    assert out["ids"].shape == (2, 6) and out["tok_s"] > 0
    want = 1 if mode == "clustered" and arch not in FLUSHES else 0
    assert out["recluster_count"] == want
