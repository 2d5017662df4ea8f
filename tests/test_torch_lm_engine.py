"""LM serving (``repro_torch.serve.Engine``, ``launch/serve.py --mode
dense|clustered``) against the JAX package's ``Engine`` on the CPU.

The JAX package's weights cross through ``models.bridge``. Greedy ids are
compared where the JAX engine's top-two logit margin exceeds 1e-3 at every
step (asserted on the data, as the index tests assert tie-free corpora), so
the comparison is not decided by float rounding. Where the clustered engine
draws its initial centroids, the port's draw is replaced by the JAX
package's (one ``PRNGKey(0)`` for every head). Everything in f32.
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


def _models(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget(arch).reduced(), **over)
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _prompt(cfg, seed, b=2, s=32):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_generate(jcfg, jp, scfg, tokens, steps):
    """The JAX engine's ids, recluster count, and the smallest top-two
    margin of every logit row it sampled from."""
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
    ids = eng.generate(jnp.asarray(tokens), steps)
    return np.asarray(ids), eng.recluster_count, min(margins)


@pytest.mark.parametrize("arch,seed", [("llama3-8b", 11),
                                       ("starcoder2-3b", 12)])
def test_dense_greedy_ids_equal_the_jax_engine(arch, seed):
    jcfg, tcfg, jp, tp = _models(arch)
    tokens = _prompt(jcfg, seed)
    scfg = ServeConfig(max_seq=48, mode="dense")
    want, _, margin = _jax_generate(jcfg, jp, scfg, tokens, 10)
    assert margin > MARGIN, f"near-tie data (margin {margin})"
    got = Engine(tcfg, tp, scfg).generate(torch.from_numpy(tokens), 10)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_clustered_with_every_cluster_equals_the_jax_dense_engine():
    """``top`` = kc (4 at a prompt of 32) and a capacity over every row:
    the sparse decode attends to every key, so the greedy ids are the
    dense engine's; ``recent`` 4 over 10 steps flushes twice."""
    jcfg, tcfg, jp, tp = _models("llama3-8b", kv_cluster_top=4)
    tokens = _prompt(jcfg, 13)
    dense = ServeConfig(max_seq=48, mode="dense")
    want, _, margin = _jax_generate(jcfg, jp, dense, tokens, 10)
    assert margin > MARGIN, f"near-tie data (margin {margin})"
    clust = ServeConfig(max_seq=48, mode="clustered", recent=4)
    _, jcount, _ = _jax_generate(jcfg, jp, clust, tokens, 10)
    eng = Engine(tcfg, tp, clust)
    got = eng.generate(torch.from_numpy(tokens), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.recluster_count == jcount == 2


def _jax_rows(monkeypatch):
    """Replace the port's initial draw by the JAX package's rows of one
    ``PRNGKey(0)`` (``random_init`` on the row indices themselves)."""
    def rows(x, kc, *, seed=0):
        idx = random_init(jax.random.PRNGKey(seed),
                          jnp.arange(x.shape[1], dtype=jnp.float32)[:, None],
                          kc)
        return x.index_select(1, torch.from_numpy(
            np.asarray(idx)[:, 0].astype(np.int64)))
    monkeypatch.setattr(kma, "initial_centroids", rows)


def test_sparse_clustered_ids_equal_the_jax_clustered_engine(monkeypatch):
    """``top`` 2 of 4 clusters: a truly sparse decode. From the same
    initial centroids the port's clustered engine gives the JAX clustered
    engine's ids and flush count."""
    _jax_rows(monkeypatch)
    jcfg, tcfg, jp, tp = _models("llama3-8b")
    assert (jcfg.kv_cluster_top, jcfg.kv_cluster_k) == (2, 8)
    tokens = _prompt(jcfg, 14)
    clust = ServeConfig(max_seq=48, mode="clustered", recent=4)
    want, jcount, margin = _jax_generate(jcfg, jp, clust, tokens, 10)
    assert margin > MARGIN, f"near-tie data (margin {margin})"
    eng = Engine(tcfg, tp, clust)
    got = eng.generate(torch.from_numpy(tokens), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.recluster_count == jcount == 2


def test_cluster_caches_match_the_jax_engine(monkeypatch):
    """The clustered layout built from the prefill caches (every group,
    sequence and kv head in one batched fit) equals the JAX engine's."""
    _jax_rows(monkeypatch)
    jcfg, tcfg, jp, tp = _models("gemma2-27b")
    tokens = _prompt(jcfg, 15, s=40)
    jeng = JEngine(jcfg, jp, JServeConfig(max_seq=48, mode="clustered",
                                          recent=4))
    _, jc, _ = jeng._prefill(jp, jnp.asarray(tokens))
    want = jax.tree_util.tree_map(np.asarray, jeng._cluster_caches(jc, 40))
    teng = Engine(tcfg, tp, ServeConfig(max_seq=48, mode="clustered",
                                        recent=4))
    _, tc, _ = teng._prefill(torch.from_numpy(tokens))
    got = bridge.caches_to_numpy(teng._cluster_caches(tc, 40))
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]), key
        for name, w in want[key].items():
            assert got[key][name].shape == w.shape, (key, name)
            np.testing.assert_allclose(got[key][name], w, rtol=1e-4,
                                       atol=1e-4, err_msg=f"{key}/{name}")
        np.testing.assert_array_equal(got[key]["bcount"],
                                      want[key]["bcount"])


def test_generate_zero_steps_returns_an_empty_int32_batch():
    _, tcfg, _, tp = _models("starcoder2-3b")
    out = Engine(tcfg, tp, ServeConfig(max_seq=64)).generate(
        torch.from_numpy(_prompt(tcfg, 16, s=16)), 0)
    assert out.shape == (2, 0) and out.dtype == torch.int32


def test_temperature_sampling_draws_from_the_generator():
    _, tcfg, _, tp = _models("llama3-8b")
    eng = Engine(tcfg, tp, ServeConfig(max_seq=48, temperature=0.8))
    tokens = torch.from_numpy(_prompt(tcfg, 17))
    a = eng.generate(tokens, 6, generator=torch.Generator().manual_seed(3))
    b = eng.generate(tokens, 6, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_padded()
    greedy = eng.generate(tokens, 6)          # no generator: greedy
    assert torch.equal(greedy, Engine(tcfg, tp, ServeConfig(
        max_seq=48)).generate(tokens, 6))


def test_engine_refuses_a_mesh_and_unknown_modes():
    """An ``Engine`` over a mesh serves (here a 1x1 mesh: the one-device
    engine's ids, its params placed as DTensors; 4 ranks in
    ``tests/test_torch_mesh_lm_serve.py``); an unknown mode raises."""
    from _torch_train_common import mesh_of_one
    from repro_torch.utils import sharding as shd
    _, tcfg, _, tp = _models("llama3-8b")
    tokens = torch.from_numpy(_prompt(tcfg, 17))
    want = Engine(tcfg, tp, ServeConfig(max_seq=48)).generate(tokens, 4)
    with mesh_of_one() as mesh:
        eng = Engine(tcfg, tp, ServeConfig(max_seq=48), mesh=mesh)
        assert shd.is_dtensor(eng.params["embed"]["embedding"])
        assert torch.equal(eng.generate(tokens, 4), want)
    with pytest.raises(ValueError, match="serving mode"):
        Engine(tcfg, tp, ServeConfig(mode="sparse"))


@pytest.mark.parametrize("mode", ["dense", "clustered"])
def test_launcher_serves_an_lm_on_the_cpu(mode, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "llama3-8b", "--reduced", "--mode", mode,
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "32", "--gen", "6", "--recent", "4"])
    text = capsys.readouterr().out
    assert f"arch=llama3-8b mode={mode} batch=2 prompt=32 gen=6" in text
    assert "tok/s" in text and "sample ids:" in text
    assert out["ids"].shape == (2, 6) and out["tok_s"] > 0
    assert out["recluster_count"] == (1 if mode == "clustered" else 0)
