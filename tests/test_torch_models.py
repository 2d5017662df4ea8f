"""The LM substrate (``repro_torch.configs``, ``repro_torch.models``)
against the JAX package on the CPU.

Config records field by field; RoPE, the norms, the MLPs and attention on
the same numpy inputs; and, through ``models.bridge``, the JAX package's
weights for llama3-8b, starcoder2-3b and gemma2-27b (reduced): the full
forward's logits, ``prefill`` and eight ``decode_step``s, with their caches.
Everything in f32.
"""
import dataclasses

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
from repro.models.layers import attention as jattn
from repro_torch.configs import base as tbase
from repro_torch.models import bridge, common
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models.common import Ctx
from repro_torch.models.layers import attention as tattn

JC = JCtx(mesh=None, compute_dtype=jnp.float32)
TC = Ctx(compute_dtype=torch.float32, device="cpu")
ARCHS = ["llama3-8b", "starcoder2-3b", "gemma2-27b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---- configs ----------------------------------------------------------------

def test_all_ten_config_records_equal_the_reference():
    want, got = jbase.all_configs(), tbase.all_configs()
    assert sorted(got) == sorted(want) and len(got) == 10
    for name, w in want.items():
        g = got[name]
        assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        assert g.n_params() == w.n_params(), name
        assert g.n_active_params() == w.n_active_params(), name
        assert g.vocab_padded() == w.vocab_padded(), name
        assert g.resolved_head_dim == w.resolved_head_dim, name
        assert dataclasses.asdict(g.reduced()) == \
            dataclasses.asdict(w.reduced()), name
        assert g.reduced().n_params() == w.reduced().n_params(), name
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("gpt-2")


def test_llama3_8b_full_width_record():
    cfg = tbase.get_config("llama3-8b")
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.num_layers) == (4096, 32, 8, 128, 14336, 32)
    assert cfg.vocab_padded() == 128512
    assert 8.0e9 < cfg.n_params() < 8.1e9


# ---- layers -----------------------------------------------------------------

def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 37, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 137, dtype=np.int32), (2, 3, 37))
    for theta in (10000.0, 500000.0):
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  theta=theta)
        got = common.apply_rope(_t(x), _t(pos), theta=theta)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_1p", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 32)) * 4 + 1).astype(np.float32)
    (jp, _), japply = jcommon.make_norm(kind, 32)
    jp = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
          for k, v in jp.items()}
    want = japply({k: jnp.asarray(v) for k, v in jp.items()},
                  jnp.asarray(x), JC)
    got = common.norm_apply(kind)({k: _t(v) for k, v in jp.items()}, _t(x),
                                  TC)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind,act", [("glu", "silu"), ("glu", "gelu"),
                                      ("plain", "gelu")])
def test_mlps_match_jax(kind, act):
    rng = np.random.default_rng(2)
    jp, _ = jcommon.mlp_init(jax.random.PRNGKey(0), 16, 48, kind=kind)
    jp = {k: np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(
        np.float32) for k, v in jp.items()}
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    want = jcommon.mlp({k: jnp.asarray(v) for k, v in jp.items()},
                       jnp.asarray(x), JC, kind=kind, act=act)
    got = common.mlp({k: _t(v) for k, v in jp.items()}, _t(x), TC,
                     kind=kind, act=act)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s,chunk,window,softcap", [
    (256, 64, None, None), (256, 64, 40, 20.0), (192, 128, None, 30.0),
    (100, 64, None, None)])
def test_chunked_attention_matches_dot_and_jax(s, chunk, window, softcap):
    """The chunk recurrence (with its divisor rule for S % chunk != 0: 192
    over 128 takes 96; 100 over 64 falls back to plain attention) equals
    plain attention and the JAX package's chunked attention."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), chunk=chunk, **kw)
    dot = tattn.dot_attention(_t(q), _t(k), _t(v), **kw)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), chunk=chunk, **kw)
    np.testing.assert_allclose(_np(got), _np(dot), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dot_attention_decode_offset_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 3, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 20, 4, 8)).astype(np.float32)
    v = rng.normal(size=(1, 20, 4, 8)).astype(np.float32)
    want = jattn.dot_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=6,
                               q_offset=12)
    got = tattn.dot_attention(_t(q), _t(k), _t(v), causal=True, window=6,
                              q_offset=12)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---- whole models through the bridge ----------------------------------------

def _models(arch):
    jcfg = jbase.get_config(arch).reduced()
    tcfg = tbase.get_config(arch).reduced()
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(tcfg, jax.tree_util.tree_map(np.asarray,
                                                               jp), "cpu")
    return jcfg, tcfg, jp, tp


def _jax_forward(cfg, params, tokens):
    x = JM._embed_tokens(cfg, params, tokens, JC)
    x, _, _ = JT.apply_stack(params["stack"], x, JC, cfg,
                             positions=JM._positions(x))
    return JM._logits(cfg, params, JM._final_norm(cfg, params, x, JC), JC)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-4, err_msg=msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch):
    """Full-forward logits, prefill's logits and caches, and 8 decode steps
    (logits and caches) equal the JAX package's; S = 48 crosses gemma2's
    reduced window of 32."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    want = np.asarray(_jax_forward(jcfg, jp, jnp.asarray(toks)))
    got = _np(TM.forward(tp, _t(toks), TC, tcfg))
    assert got.shape == (2, 48, tcfg.vocab_padded())
    _close(got, want, "forward")

    jl, jcache, _ = JM.prefill(jp, jnp.asarray(toks[:, :40]), JC, jcfg,
                               max_seq=56)
    tl, tcache, _ = TM.prefill(tp, _t(toks[:, :40]), TC, tcfg, max_seq=56)
    _close(_np(tl), jl, "prefill")
    for t in range(40, 48):
        jl, jcache = JM.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                    jcache, JC, jcfg)
        tl, tcache = TM.decode_step(tp, _t(toks[:, t:t + 1]), tcache, TC,
                                    tcfg)
        _close(_np(tl), jl, f"decode {t}")
        _close(_np(tl)[:, 0], got[:, t], f"decode {t} vs forward")
    want_c = jax.tree_util.tree_map(np.asarray, jcache)
    got_c = bridge.caches_to_numpy(tcache)
    assert sorted(got_c) == sorted(want_c)
    for key in want_c:
        assert sorted(got_c[key]) == sorted(want_c[key])
        for name, w in want_c[key].items():
            assert got_c[key][name].shape == w.shape, (key, name)
            _close(got_c[key][name], w, f"{key}/{name}")


def test_decode_from_zero_caches_matches_jax_ring_and_split():
    """gemma2 from ``init_decode_caches("dense")``: the local layers decode
    through the ring buffer, the global ones through the split cache."""
    jcfg, tcfg, jp, tp = _models("gemma2-27b")
    jcache = JM.init_decode_caches(jcfg, 1, 64, dtype=jnp.float32)
    tcache = bridge.caches_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    assert "ring" in tcache["0_attn_local"] and "blen" in \
        tcache["1_attn_global"]
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                             (1, 5)).astype(np.int32)
    for t in range(5):
        jl, jcache = JM.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                    jcache, JC, jcfg)
        tl, tcache = TM.decode_step(tp, _t(toks[:, t:t + 1]), tcache, TC,
                                    tcfg)
        _close(_np(tl), jl, f"step {t}")


def test_split_decode_matches_dense():
    """The split bulk + append cache gives the dense path's logits (ref.
    ``tests/serve/test_decode.py:141``)."""
    _, tcfg, _, tp = _models("llama3-8b")
    toks = _t(np.random.default_rng(7).integers(0, tcfg.vocab_size,
                                                (2, 40)).astype(np.int32))
    logits_p, caches, _ = TM.prefill(tp, toks, TC, tcfg, max_seq=48)
    nxt = torch.argmax(logits_p[:, -1], -1).unsqueeze(1).to(torch.int32)
    split = {}
    subs, n_groups = TT.group_layout(tcfg)
    kh, hd = tcfg.num_kv_heads, tcfg.resolved_head_dim
    for i, sub in enumerate(subs):
        key = f"{i}_{sub}"
        dc = dict(caches[key])
        dc["k"] = dc["k"][:, :, :40].clone()        # bulk = the prefill
        dc["v"] = dc["v"][:, :, :40].clone()
        dc["append_k"] = torch.zeros((n_groups, 2, 16, kh, hd))
        dc["append_v"] = torch.zeros((n_groups, 2, 16, kh, hd))
        dc["rlen"] = torch.zeros((n_groups,), dtype=torch.int32)
        dc["blen"] = torch.full((n_groups,), 40, dtype=torch.int32)
        split[key] = dc
    dense_caches = {k: {n: t.clone() for n, t in c.items()}
                    for k, c in caches.items()}
    logits_dense, _ = TM.decode_step(tp, nxt, dense_caches, TC, tcfg)
    logits_split, split = TM.decode_step(tp, nxt, split, TC, tcfg)
    torch.testing.assert_close(logits_split, logits_dense, rtol=1e-3,
                               atol=1e-3)
    assert int(split["0_block"]["rlen"][0]) == 1


@pytest.mark.parametrize("mode", ["dense", "clustered"])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_init_decode_caches_match_jax(arch, mode):
    jcfg = jbase.get_config(arch).reduced()
    tcfg = tbase.get_config(arch).reduced()
    want = JM.init_decode_caches(jcfg, 2, 1024, mode=mode, dtype=jnp.float32,
                                 recent=16)
    got = TM.init_decode_caches(tcfg, 2, 1024, mode=mode,
                                dtype=torch.float32, recent=16, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert sorted(got[key]) == sorted(want[key]), key
        for name, w in want[key].items():
            g = got[key][name]
            assert tuple(g.shape) == w.shape, (key, name)
            assert str(g.dtype).split(".")[1] == str(w.dtype), (key, name)
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert TM.clustered_geometry(tcfg, 1024) == \
        JM.clustered_geometry(jcfg, 1024)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_tree_matches_jax(arch):
    jcfg = jbase.get_config(arch).reduced()
    tcfg = tbase.get_config(arch).reduced()
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tp = TM.init_model(tcfg, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = TT.tree_map(lambda t: tuple(t.shape), tp)
    assert tshapes == jshapes
    assert TM.n_elements(tp) == sum(
        a.size for a in jax.tree_util.tree_leaves(jp))
    again = TM.init_model(tcfg, device="cpu")
    assert torch.equal(again["embed"]["embedding"], tp["embed"]["embedding"])


def test_routed_train_forward_is_finite():
    """``kmeans_attn`` layers (forward only) route through
    ``kmeans_routed_attention`` with the plain dataflows."""
    tcfg = dataclasses.replace(tbase.get_config("llama3-8b").reduced(),
                               kmeans_attn=True, kv_cluster_k=4)
    tp = TM.init_model(tcfg, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(0))
    logits = TM.forward(tp, toks, TC, tcfg)
    assert logits.shape == (2, 64, tcfg.vocab_padded())
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("entry", ["init_model", "init_decode_caches/dense",
                                   "init_decode_caches/clustered",
                                   "init_cache", "init_clustered_cache"])
def test_entry_points_default_to_cuda(entry):
    """Without ``device`` the model's entry points allocate on ``cuda``
    (and raise where there is none): never on the CPU on their own."""
    from repro_torch.models import kmeans_attention as kma
    cfg = tbase.get_config("llama3-8b").reduced()
    call = {"init_model": lambda: TM.init_model(cfg),
            "init_decode_caches/dense":
                lambda: TM.init_decode_caches(cfg, 1, 64),
            "init_decode_caches/clustered":
                lambda: TM.init_decode_caches(cfg, 1, 64, mode="clustered",
                                              recent=4),
            "init_cache": lambda: TT.init_cache(cfg, 1, 64),
            "init_clustered_cache": lambda: kma.init_clustered_cache(
                1, 2, 8, kc=4, capacity=8, recent=4)}[entry]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        return
    out = call()
    leaves = jax.tree_util.tree_leaves(out, is_leaf=torch.is_tensor)
    assert leaves and all(t.device.type == "cuda" for t in leaves)


def test_ctx_with_a_mesh_refuses_constraints():
    """``Ctx.constrain`` is the identity without a mesh and on a plain
    tensor; on a mesh it redistributes a DTensor to the placements its
    logical spec resolves to, the values unchanged."""
    from _torch_train_common import mesh_of_one
    from repro_torch.utils import sharding as shd
    x = torch.arange(6.0).reshape(2, 3)
    assert Ctx(device="cpu").constrain(x, "dp") is x
    with mesh_of_one() as mesh:
        ctx = Ctx(device="cpu", mesh=mesh)
        assert ctx.constrain(x, "dp") is x
        d = shd.place(x, mesh, shd.placements((None, "model"), mesh))
        y = ctx.constrain(d, "dp", None)
        assert list(y.placements) == shd.placements(
            shd.resolve_spec(("dp", None), (2, 3), mesh), mesh)
        assert torch.equal(shd.gather(y), x)
