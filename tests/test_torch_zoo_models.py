"""The rest of the LM zoo (MoE, MLA, zamba2's Mamba2 with its shared
block, xLSTM, whisper's encoder and cross-attention, phi-3-vision's
frontend) against the JAX package on the CPU, each config reduced.

The JAX package's weights cross through ``models.bridge``. For each of the
seven configs: the init tree's shapes, the full forward's logits,
``prefill``'s logits, caches and cross-KV, 8 ``decode_step``s with their
caches, and ``init_decode_caches`` in both modes, tree for tree. Everything
in f32 at rtol = atol = 1e-4, except where xLSTM's chunk scan rounds its
operands to bfloat16 (stated at the test). The JAX ``decode_step`` is
jitted with ``functools.partial``, as the JAX ``Engine`` jits it, so each
config compiles once.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.common import Ctx as JCtx
from repro_torch.configs import base as tbase
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.common import Ctx

JC = JCtx(mesh=None, compute_dtype=jnp.float32)
TC = Ctx(compute_dtype=torch.float32, device="cpu")
ZOO = ["granite-moe-1b-a400m", "dbrx-132b", "minicpm3-4b", "zamba2-7b",
       "xlstm-1.3b", "phi-3-vision-4.2b", "whisper-base"]
MAX_POS = 128
TOL = 1e-4
# xLSTM: the chunk scan rounds q, k, v and its weights to bfloat16 in both
# packages, and q, k, v come out of f32 products that the two packages sum
# in different orders: an input one f32 ulp apart can round to the
# neighbouring bfloat16 value (2^-8 relative). The logits hold at 1e-3;
# the carried mLSTM state (C_hat sums such products over the chunk) at the
# reference's own bfloat16 tolerance, 2e-2 (tests/models/test_layers.py).
TOL_BF16 = (1e-3, 2e-2)


def _tol(cfg):
    """(logits, caches) tolerances."""
    return TOL_BF16 if cfg.family == "ssm" else (TOL, TOL)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jbase.get_config(arch).reduced()
    tcfg = tbase.get_config(arch).reduced()
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, max_pos=MAX_POS)
    tp = bridge.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               jp), "cpu")
    return jcfg, tcfg, jp, tp


def _frontend(cfg, seed, b=2):
    if not cfg.frontend:
        return None
    return np.random.default_rng(seed).normal(
        size=(b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def _opt(a, fn):
    return None if a is None else fn(a)


def _np_tree(tree):
    return TT.tree_map(lambda t: t.detach().float().numpy(), tree)


def _trees_close(got, want, tol, what):
    """The same tree structure (dict keys, tuples) and every leaf within
    ``tol``."""
    got = _np_tree(got)
    want = jax.tree_util.tree_map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want), what
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape, (what, path)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what} {path}")


def _jax_forward(cfg, params, tokens, frontend):
    """The reference's full forward (``loss_fn`` up to its logits)."""
    x = JM._embed_tokens(cfg, params, tokens, JC)
    cross_kv, n_front = None, 0
    if cfg.family == "audio":
        cross_kv = JM._encoder_ctx(cfg, params, frontend, JC)
    elif cfg.frontend:
        patches = jcommon.dense(params["frontend"], frontend, JC)
        x = jnp.concatenate([patches, x], axis=1)
        n_front = patches.shape[1]
    if cfg.learned_pos:
        x = x + params["pos_embed"][None, :x.shape[1]]
    x, _, _ = JT.apply_stack(
        params["stack"], x, JC, cfg,
        positions=None if cfg.learned_pos else JM._positions(x),
        cross_kv=cross_kv)
    x = JM._final_norm(cfg, params, x, JC)
    return JM._logits(cfg, params, x[:, n_front:], JC)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("arch", ZOO)
def test_init_model_tree_matches_jax(arch):
    jcfg, tcfg, jp, _ = _models(arch)
    tp = TM.init_model(tcfg, device="cpu", max_pos=MAX_POS)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert TT.tree_map(lambda t: tuple(t.shape), tp) == jshapes
    assert TM.n_elements(tp) == sum(
        a.size for a in jax.tree_util.tree_leaves(jp))
    assert ("shared" in tp["stack"]) == (tcfg.family == "hybrid")
    assert ("encoder" in tp) == bool(tcfg.encoder_layers)
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(tp))


@pytest.mark.parametrize("arch", ZOO)
def test_forward_prefill_and_decode_match_jax(arch):
    """The forward over 32 tokens (and the frontend), prefill of the first
    24 (logits, caches grown to 56 slots past the patches, cross-KV), then
    8 decode steps (logits, and the caches after them)."""
    jcfg, tcfg, jp, tp = _models(arch)
    tol, ctol = _tol(tcfg)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    fe = _frontend(jcfg, 6)
    want = np.asarray(_jax_forward(jcfg, jp, jnp.asarray(toks),
                                   _opt(fe, jnp.asarray)))
    got = TM.forward(tp, torch.from_numpy(toks), TC, tcfg,
                     frontend=_opt(fe, torch.from_numpy))
    assert got.shape == (2, 32, tcfg.vocab_padded())
    _close(got.numpy(), want, tol, "forward")

    max_seq = 56 + (jcfg.frontend_seq if jcfg.family == "vlm" else 0)
    jl, jcache, jcross = JM.prefill(jp, jnp.asarray(toks[:, :24]), JC, jcfg,
                                    max_seq=max_seq,
                                    frontend=_opt(fe, jnp.asarray))
    tl, tcache, tcross = TM.prefill(tp, torch.from_numpy(toks[:, :24]), TC,
                                    tcfg, max_seq=max_seq,
                                    frontend=_opt(fe, torch.from_numpy))
    _close(tl.numpy(), jl, tol, "prefill")
    _trees_close(tcache, jcache, ctol, "prefill caches")
    assert (tcross is None) == (jcross is None)
    if jcross is not None:
        _trees_close(tcross, jcross, TOL, "cross_kv")
    dec = jax.jit(functools.partial(JM.decode_step, ctx=JC, cfg=jcfg))
    for t in range(24, 32):
        jl, jcache = dec(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                         cross_kv=jcross)
        tl, tcache = TM.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                    tcache, TC, tcfg, cross_kv=tcross)
        _close(tl.numpy(), jl, tol, f"decode {t}")
    _trees_close(tcache, jcache, ctol, "decoded caches")


@pytest.mark.parametrize("mode", ["dense", "clustered"])
@pytest.mark.parametrize("arch", ZOO)
def test_init_decode_caches_match_jax(arch, mode):
    jcfg = jbase.get_config(arch).reduced()
    tcfg = tbase.get_config(arch).reduced()
    want = JM.init_decode_caches(jcfg, 2, 1024, mode=mode, dtype=jnp.float32,
                                 recent=16)
    got = TM.init_decode_caches(tcfg, 2, 1024, mode=mode,
                                dtype=torch.float32, recent=16, device="cpu")
    _trees_close(got, want, 0.0, f"{arch}/{mode}")
    dtypes = [str(t.dtype).split(".")[1] for t in
              jax.tree_util.tree_leaves(got)]
    assert dtypes == [str(w.dtype) for w in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("arch", ["whisper-base", "zamba2-7b",
                                  "minicpm3-4b"])
def test_decode_from_zero_caches_matches_jax(arch):
    """Decode from ``init_decode_caches("dense")``: zamba2's shared block
    through the split cache, MLA's latents from position 0, and whisper's
    learned position read from the first 1-D int32 leaf in JAX's leaf
    order, ``blen`` of the split cache (the reference's ``_first_pos``),
    clamped into the table."""
    jcfg, tcfg, jp, tp = _models(arch)
    jcache = JM.init_decode_caches(jcfg, 1, 64, dtype=jnp.float32)
    tcache = bridge.caches_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    jcross = tcross = None
    if jcfg.family == "audio":
        fe = _frontend(jcfg, 7, b=1)
        _, _, jcross = JM.prefill(jp, jnp.zeros((1, 1), jnp.int32), JC, jcfg,
                                  max_seq=8, frontend=jnp.asarray(fe))
        tcross = bridge.caches_from_numpy(
            jax.tree_util.tree_map(np.asarray, jcross), "cpu")
        assert int(TM._first_pos(tcache)) == 64
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                             (1, 4)).astype(np.int32)
    dec = jax.jit(functools.partial(JM.decode_step, ctx=JC, cfg=jcfg))
    for t in range(4):
        jl, jcache = dec(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                         cross_kv=jcross)
        tl, tcache = TM.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                    tcache, TC, tcfg, cross_kv=tcross)
        _close(tl.numpy(), jl, TOL, f"step {t}")


@pytest.mark.parametrize("gs,differs", [(64, True), (1, False)])
def test_reference_moe_decode_equals_its_forward_only_per_token(gs, differs):
    """The reference's MoE semantics, which phase 14 of ``chip_smoke.py``
    relies on: a (token, slot) pair's place in its expert is a cumsum over
    the group, so pairs of different tokens share places and are summed,
    and a multi-token forward is not what one-token decode steps compute.
    With groups of 64 the JAX package's own decode differs from its forward
    by more than 0.1 in the logits; with one token a group (capacity 1,
    never dropped or shared) they agree within 1e-4. The port follows."""
    jcfg, tcfg, jp, tp = _models("granite-moe-1b-a400m")
    jcfg = dataclasses.replace(jcfg, moe_group_size=gs)
    tcfg = dataclasses.replace(tcfg, moe_group_size=gs)
    toks = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (1, 64)).astype(np.int32)
    full = np.asarray(_jax_forward(jcfg, jp, jnp.asarray(toks), None))
    _, jcache, _ = JM.prefill(jp, jnp.asarray(toks[:, :48]), JC, jcfg,
                              max_seq=72)
    _, tcache, _ = TM.prefill(tp, torch.from_numpy(toks[:, :48]), TC, tcfg,
                              max_seq=72)
    dec = jax.jit(functools.partial(JM.decode_step, ctx=JC, cfg=jcfg))
    gap = 0.0
    for t in range(48, 64):
        jl, jcache = dec(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
        tl, tcache = TM.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                    tcache, TC, tcfg)
        _close(tl.numpy(), jl, TOL, f"decode {t}")
        gap = max(gap, float(np.abs(np.asarray(jl)[:, 0] - full[:, t]).max()))
    assert (gap > 0.1) if differs else (gap < TOL), gap


def test_first_pos_reads_jax_leaf_order():
    """Sorted keys at every level, tuples in order: ``blen`` sorts before
    ``pos``; a tree with no 1-D int32 leaf reads 0."""
    i32 = torch.int32
    caches = {"1_b": {"pos": torch.tensor([7], dtype=i32)},
              "0_a": {"v": torch.zeros(2, 3), "pos": torch.tensor(
                  [5], dtype=i32), "blen": torch.tensor([9], dtype=i32)}}
    assert int(TM._first_pos(caches)) == 9
    assert int(TM._first_pos({"0_a": {"mlstm": (torch.zeros(3),)}})) == 0


def test_mesh_still_refuses():
    """zamba2 (Mamba2 and the shared attention block) runs over a mesh:
    its forward on a 1x1 mesh, the params placed by their spec tree, gives
    the one-device logits."""
    from _torch_train_common import mesh_of_one
    from repro_torch.utils import sharding as shd
    _, tcfg, _, tp = _models("zamba2-7b")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    want = TM.forward(tp, tokens, TC, tcfg)
    with mesh_of_one() as mesh:
        ctx = Ctx(compute_dtype=torch.float32, device="cpu", mesh=mesh)
        placed = shd.place_tree(tp, TM.model_specs(tcfg), mesh)
        tok = shd.place(tokens, mesh, shd.placements(("data",), mesh))
        got = shd.gather(TM.forward(placed, tok, ctx, tcfg))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_recurrent_prefill_needs_whole_chunks():
    """zamba2's Mamba2 chunk is ``min(ssm_chunk, S)``: a prompt of 300 is
    not a whole number of chunks of 256, and the port raises as the
    reference asserts."""
    cfg = dataclasses.replace(tbase.get_config("zamba2-7b").reduced(),
                              num_layers=3)
    tp = TM.init_model(cfg, device="cpu", max_pos=8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TM.prefill(tp, torch.zeros((1, 300), dtype=torch.int32), TC, cfg,
                   max_seq=304)


def test_cluster_caches_use_the_text_length_after_patches(monkeypatch):
    """phi-3-vision: the engine clusters the first S_text cache rows (the
    reference passes ``tokens.shape[1]`` though the 16 patches come first),
    and the cluster cache's ``pos`` is the prefill's, past the patches."""
    from repro.core.init import random_init
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro_torch.models import kmeans_attention as kma
    from repro_torch.serve import Engine, ServeConfig

    def rows(x, kc, *, seed=0):   # the JAX package's initial draw
        idx = random_init(jax.random.PRNGKey(seed), jnp.arange(
            x.shape[1], dtype=jnp.float32)[:, None], kc)
        return x.index_select(1, torch.from_numpy(
            np.asarray(idx)[:, 0].astype(np.int64)))
    monkeypatch.setattr(kma, "initial_centroids", rows)
    jcfg, tcfg, jp, tp = _models("phi-3-vision-4.2b")
    tokens = np.random.default_rng(23).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    fe = _frontend(jcfg, 24)
    scfg = ServeConfig(max_seq=24 + 16 + 8 + jcfg.frontend_seq,
                       mode="clustered", recent=4)
    jeng = JEngine(jcfg, jp, JServeConfig(**dataclasses.asdict(scfg)))
    _, jc, _ = jeng._prefill(jp, jnp.asarray(tokens),
                             frontend=jnp.asarray(fe))
    want = jax.tree_util.tree_map(np.asarray, jeng._cluster_caches(jc, 24))
    teng = Engine(tcfg, tp, scfg)
    _, tc, _ = teng._prefill(torch.from_numpy(tokens), torch.from_numpy(fe))
    got = bridge.caches_to_numpy(teng._cluster_caches(tc, 24))
    assert sorted(got) == sorted(want) == ["0_block"]
    for name, w in want["0_block"].items():
        np.testing.assert_allclose(got["0_block"][name], w, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert got["0_block"]["cweight"].sum(-1).max() == 24
    assert (got["0_block"]["pos"] == 24 + jcfg.frontend_seq).all()
