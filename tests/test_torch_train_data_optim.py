"""The training data pipeline and AdamW of the port against the JAX
package on the CPU.

``repro_torch.data.pipeline`` draws the same numpy batches as
``repro.data.pipeline`` (bit for bit: the same ``SeedSequence([seed,
step])`` draw); ``repro_torch.optim.adamw`` computes the reference's update
(bias corrections inside the square root, ``eps`` after it, the decay inside
the step), its global norm, clipping and cosine schedule, held to the JAX
functions on the same numpy trees at f32 (rtol = atol = 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.specs import train_batch_specs
from repro_torch.optim import adamw
from repro_torch.utils.tree import tree_leaves, tree_map

TOL = 1e-6


@pytest.mark.parametrize("cfg", [
    dict(seed=0, vocab_size=512, batch=2, seq_len=16),
    dict(seed=7, vocab_size=50304, batch=3, seq_len=33, frontend_seq=5,
         d_model=8, zipf_a=1.5)])
def test_batches_are_the_references_bit_for_bit(cfg):
    jp = jpipe.SyntheticPipeline(jpipe.DataConfig(**cfg))
    tp = tpipe.SyntheticPipeline(tpipe.DataConfig(**cfg))
    for step in (0, 1, 9, 12345):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it_j, it_t = iter(jp), iter(tp)
    for _ in range(3):
        a, b = next(it_j), next(it_t)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("arch", ["llama3-8b", "phi-3-vision-4.2b",
                                  "whisper-base"])
def test_pipeline_for_and_the_batch_specs_follow_the_reference(arch):
    jcfg = jbase.get_config(arch).reduced()
    tcfg = tbase.get_config(arch).reduced()
    shape = tbase.ShapeSpec("t", 64, 2, "train")
    jshape = jbase.ShapeSpec("t", 64, 2, "train")
    jp = jpipe.pipeline_for(jcfg, jshape, seed=3, batch_override=3)
    tp = tpipe.pipeline_for(tcfg, shape, seed=3, batch_override=3)
    assert tp.cfg == tpipe.DataConfig(**vars(jp.cfg))
    want, got = jp.batch_at(5), tp.batch_at(5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    specs = train_batch_specs(tcfg, tbase.ShapeSpec("t", 64, 3, "train"))
    for k, (shp, dt) in specs.items():
        assert got[k].shape == shp, k
        assert torch.from_numpy(got[k]).dtype == dt, k
    on_dev = tpipe.put_batch(got, "cpu")
    assert on_dev["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(on_dev["labels"].numpy(), got["labels"])


def test_a_mesh_is_refused_naming_item_8a():
    with pytest.raises(NotImplementedError, match="queue A item 8a"):
        tpipe.put_batch({"tokens": np.zeros((1, 2), np.int32)}, "cpu",
                        mesh=object())
    with pytest.raises(NotImplementedError, match="queue A item 8a"):
        train_batch_specs(tbase.get_config("llama3-8b"),
                          tbase.SHAPES["train_4k"], mesh=object())


def _tree(rng, scale=1.0):
    """A nested tree of f32 leaves (dicts in dicts, a stacked leaf)."""
    def n(*s):
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return {"embed": {"embedding": n(17, 8)},
            "stack": {"groups": {"0_block": {"w": n(3, 8, 5), "b": n(3, 5)}}},
            "final_norm": {"scale": n(8)}}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL):
    got_l = [np.asarray(x) for x in tree_leaves(tree_map(
        lambda t: t.numpy() if torch.is_tensor(t) else t, got))]
    want_l = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_global_norm_and_clipping_match(scale):
    tree = _tree(np.random.default_rng(0), scale)
    want_n = jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    got_n = adamw.global_norm(_t(tree))
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=TOL)
    want, wn = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    mine = _t(tree)
    leaves = tree_leaves(mine)
    got, gn = adamw.clip_by_global_norm(mine, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=TOL)
    _close(got, want)
    # scaled in place
    assert got is mine and all(x is y for x, y in zip(tree_leaves(got),
                                                      leaves))


@pytest.mark.parametrize("cfg", [
    dict(), dict(clip_norm=0.0, weight_decay=0.0, b2=0.999, eps=1e-6)])
def test_update_matches_the_reference_over_steps(cfg):
    """Four AdamW steps from the same params and gradients: params,
    moments and count within f32 rounding of the reference's, written into
    the tensors the update was given."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(4)]
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadamw.init(jp)
    tp, ts = _t(params), adamw.init(_t(params))
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 0
    for step, g in enumerate(grads):
        lr = 3e-3 * (step + 1)
        jp, js = jadamw.update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                               js, jnp.float32(lr), jcfg)
        given = tree_leaves((tp, ts["m"], ts["v"]))
        tp, ts = adamw.update(tp, _t(g), ts, lr, tcfg)
        assert all(x is y for x, y in zip(
            tree_leaves((tp, ts["m"], ts["v"])), given))
        _close(tp, jp)
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["count"]) == int(js["count"]) == step + 1


@pytest.mark.parametrize("base,warmup,total,min_frac", [
    (3e-4, 100, 10000, 0.1), (1e-3, 10, 20, 0.0), (2e-4, 0, 5, 0.5)])
def test_cosine_schedule_matches(base, warmup, total, min_frac):
    jl = jadamw.cosine_schedule(base, warmup, total, min_frac)
    tl = adamw.cosine_schedule(base, warmup, total, min_frac)
    for step in sorted({0, 1, warmup // 2, max(warmup - 1, 0), warmup,
                        warmup + 1, (warmup + total) // 2, total - 1, total,
                        total + 7}):
        want = float(jl(jnp.int32(step)))
        got = tl(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-12)
