"""The LM zoo's layers (``repro_torch.models.layers``: MoE, MLA, Mamba2,
mLSTM, sLSTM, cross-attention) against the JAX package's on the CPU.

The same numpy weights and inputs go through both; everything in f32.
Tolerance rtol = atol = 1e-4 unless a test says otherwise; the mLSTM
chunk scan rounds the same operands to bfloat16 in both packages, so it
holds the same 1e-4 against the reference (its products of bfloat16
values are exact in f32 on both sides).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import Ctx as JCtx
from repro.models.layers import attention as jattn
from repro.models.layers import mamba2 as jm2
from repro.models.layers import mla as jmla
from repro.models.layers import moe as jmoe
from repro.models.layers import xlstm as jxl
from repro_torch.models.common import Ctx, Init
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import mamba2 as tm2
from repro_torch.models.layers import mla as tmla
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.layers import xlstm as txl

JC = JCtx(mesh=None, compute_dtype=jnp.float32)
TC = Ctx(compute_dtype=torch.float32, device="cpu")
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=msg)


def _tree_close(got, want, tol=TOL):
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got, is_leaf=torch.is_tensor))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        _close(a, b, tol)


def _weights(jparams, rng, jitter=0.0):
    """The JAX init's weights as numpy, optionally jittered (so zero biases
    and unit scales take other values)."""
    return {k: np.asarray(v) + jitter * rng.normal(size=v.shape).astype(
        np.float32) for k, v in jparams.items()}


def _both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: _t(v) for k, v in w.items()})


# ---- MoE --------------------------------------------------------------------

def _moe_case(seed, e=8, k=2, d=16, f=24, jitter=0.1):
    rng = np.random.default_rng(seed)
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e)
    return _both(_weights(jp, rng, jitter)), rng


@pytest.mark.parametrize("b,s,gs,cf", [(2, 16, 8, 1.25), (1, 24, 24, 1.25),
                                       (2, 12, 512, 1.25)])
def test_moe_matches_jax(b, s, gs, cf):
    """Output and aux loss on random tokens, one group or several."""
    (jw, tw), rng = _moe_case(0)
    x = rng.normal(size=(b, s, 16)).astype(np.float32)
    want_y, want_aux = jmoe.moe(jw, jnp.asarray(x), JC, num_experts=8,
                                top_k=2, capacity_factor=cf, group_size=gs)
    got_y, got_aux = tmoe.moe(tw, _t(x), TC, num_experts=8, top_k=2,
                              capacity_factor=cf, group_size=gs)
    _close(got_y, want_y)
    _close(got_aux, want_aux)


def test_moe_capacity_drops_match_jax():
    """A capacity factor of 0.25 drops most (token, expert) pairs: the
    dropped pairs (``one_hot`` of a place past the capacity is a zero row)
    contribute nothing, in both packages."""
    (jw, tw), rng = _moe_case(1)
    x = rng.normal(size=(2, 16, 16)).astype(np.float32)
    want, _ = jmoe.moe(jw, jnp.asarray(x), JC, num_experts=8, top_k=2,
                       capacity_factor=0.25, group_size=16)
    got, _ = tmoe.moe(tw, _t(x), TC, num_experts=8, top_k=2,
                      capacity_factor=0.25, group_size=16)
    _close(got, want)
    # the groups' places: some pairs drop, and some pairs of different
    # tokens share an (expert, place) (a token's slots pick distinct
    # experts); with one token a group every place is 0 and none drops
    _, _, top_i = tmoe.route(_t(x).reshape(2, 16, 16) @ tw["router"], 2)
    _, pos = tmoe.places(top_i, 8)
    cap = tmoe.capacity(16, 2, 8, 0.25)
    assert bool((pos >= cap).any())
    fit = [[(int(e), int(p)) for e, p in zip(top_i[g].flatten(),
                                             pos[g].flatten()) if p < cap]
           for g in range(2)]
    assert any(len(f) > len(set(f)) for f in fit)
    _, pos1 = tmoe.places(top_i.reshape(32, 1, 2), 8)
    assert not bool((pos1 >= tmoe.capacity(1, 2, 8)).any())


def test_moe_router_ties_take_the_lower_expert():
    """A zero router gives every expert the same probability: ``lax.top_k``
    takes experts 0 and 1, and so does the port (a stable sort)."""
    (jw, tw), rng = _moe_case(2, jitter=0.0)
    jw = dict(jw, router=jnp.zeros_like(jw["router"]))
    tw = dict(tw, router=torch.zeros_like(tw["router"]))
    x = rng.normal(size=(1, 8, 16)).astype(np.float32)
    _, top_p, top_i = tmoe.route(torch.zeros((1, 8, 8)), 2)
    assert top_i.tolist() == [[[0, 1]] * 8]
    want, _ = jmoe.moe(jw, jnp.asarray(x), JC, num_experts=8, top_k=2,
                       group_size=8)
    got, _ = tmoe.moe(tw, _t(x), TC, num_experts=8, top_k=2, group_size=8)
    _close(got, want)


def test_moe_refuses_a_ragged_group():
    (_, tw), _ = _moe_case(3)
    with pytest.raises(ValueError, match="whole number of groups"):
        tmoe.moe(tw, torch.zeros(1, 12, 16), TC, num_experts=8, top_k=2,
                 group_size=8)


# ---- MLA --------------------------------------------------------------------

MLA_GEOM = dict(nope_head_dim=8, rope_head_dim=4, v_head_dim=8)


def test_mla_prefill_and_decode_match_jax():
    """Prefill (the built cache), then 4 decode steps against a cache grown
    to 16 slots, each step's output and cache."""
    rng = np.random.default_rng(4)
    jp, _ = jmla.mla_init(jax.random.PRNGKey(4), 32, 4, q_lora_rank=24,
                          kv_lora_rank=16, **MLA_GEOM)
    jw, tw = _both(_weights(jp, rng, 0.05))
    kw = dict(num_heads=4, kv_lora_rank=16, rope_theta=10000.0, **MLA_GEOM)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    jy, jc = jmla.mla_attention(jw, jnp.asarray(x[:, :8]), JC, cache={}, **kw)
    ty, tc = tmla.mla_attention(tw, _t(x[:, :8]), TC, cache={}, **kw)
    _close(ty, jy)
    _tree_close(tc, jc)

    def grow(c, mod):
        pad = [(0, 0), (0, 8), (0, 0)]
        return {"latent": mod.pad(c["latent"], pad),
                "k_rope": mod.pad(c["k_rope"], pad), "pos": c["pos"]}
    jc = grow(jc, jnp)
    tc = {"latent": torch.nn.functional.pad(tc["latent"], (0, 0, 0, 8)),
          "k_rope": torch.nn.functional.pad(tc["k_rope"], (0, 0, 0, 8)),
          "pos": tc["pos"]}
    jstep = jax.jit(functools.partial(jmla.mla_attention, ctx=JC, **kw))
    for t in range(8, 12):
        jy, jc = jstep(jw, jnp.asarray(x[:, t:t + 1]), cache=jc)
        ty, tc = tmla.mla_attention(tw, _t(x[:, t:t + 1]), TC, cache=tc,
                                    **kw)
        _close(ty, jy, msg=f"step {t}")
    _tree_close(tc, jc)
    assert int(tc["pos"]) == 12


# ---- Mamba2 -----------------------------------------------------------------

M2 = dict(head_dim=8, d_state=8, conv_width=4)


def _mamba2_case(seed):
    rng = np.random.default_rng(seed)
    jp, _ = jm2.mamba2_init(jax.random.PRNGKey(seed), 16, expand=2, **M2)
    return _both(_weights(jp, rng, 0.05)), rng


@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 12), (8, 256)])
def test_mamba2_chunked_scan_matches_jax(s, chunk):
    """The chunked scan over several chunks, one, and a chunk past S."""
    (jw, tw), rng = _mamba2_case(5)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    jy, jc = jm2.mamba2(jw, jnp.asarray(x), JC, chunk=chunk, cache={}, **M2)
    ty, tc = tm2.mamba2(tw, _t(x), TC, chunk=chunk, cache={}, **M2)
    _close(ty, jy)
    _tree_close(tc, jc)


def test_mamba2_carried_state_and_steps_match_jax():
    """A prefill from a zero state, a chunked continuation from its state
    (the conv window and the SSM state carried), then 3 one-token steps;
    and the steps equal the one-pass scan over the whole sequence."""
    (jw, tw), rng = _mamba2_case(6)
    x = rng.normal(size=(1, 15, 16)).astype(np.float32)
    zeros = {"ssm": np.zeros((1, 4, 8, 8), np.float32),
             "conv": np.zeros((1, 3, 48), np.float32)}
    jc = {k: jnp.asarray(v) for k, v in zeros.items()}
    tc = {k: _t(v) for k, v in zeros.items()}
    outs = []
    for sl, chunk in ((slice(0, 8), 4), (slice(8, 12), 2), (slice(12, 13), 4),
                      (slice(13, 14), 4), (slice(14, 15), 4)):
        jy, jc = jm2.mamba2(jw, jnp.asarray(x[:, sl]), JC, chunk=chunk,
                            cache=jc, **M2)
        ty, tc = tm2.mamba2(tw, _t(x[:, sl]), TC, chunk=chunk, cache=tc,
                            **M2)
        _close(ty, jy, msg=str(sl))
        _tree_close(tc, jc)
        outs.append(ty)
    whole, _ = tm2.mamba2(tw, _t(x), TC, chunk=15, **M2)
    _close(torch.cat(outs, 1), whole, 1e-4)


def test_mamba2_refuses_a_ragged_chunk():
    (_, tw), _ = _mamba2_case(7)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm2.mamba2(tw, torch.zeros(1, 10, 16), TC, chunk=4, **M2)


# ---- xLSTM ------------------------------------------------------------------

def _mlstm_case(seed):
    rng = np.random.default_rng(seed)
    jp, _ = jxl.mlstm_init(jax.random.PRNGKey(seed), 16, 2, proj_factor=2.0)
    return _both(_weights(jp, rng, 0.05)), rng


@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 12)])
def test_mlstm_chunk_scan_matches_jax(s, chunk):
    (jw, tw), rng = _mlstm_case(8)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    jy, jc = jxl.mlstm(jw, jnp.asarray(x), JC, num_heads=2, chunk=chunk,
                       cache={})
    ty, tc = txl.mlstm(tw, _t(x), TC, num_heads=2, chunk=chunk, cache={})
    _close(ty, jy)
    _tree_close(tc, jc)


def test_mlstm_state_continuation_and_steps_match_jax():
    """A chunked prefill, a chunked continuation from its state, then 3
    recurrent (all f32) steps, each against the reference's."""
    (jw, tw), rng = _mlstm_case(9)
    x = rng.normal(size=(2, 15, 16)).astype(np.float32)
    jc, tc = {}, {}
    for sl, chunk in ((slice(0, 8), 4), (slice(8, 12), 4),
                      (slice(12, 13), 4), (slice(13, 14), 4),
                      (slice(14, 15), 4)):
        jy, jc = jxl.mlstm(jw, jnp.asarray(x[:, sl]), JC, num_heads=2,
                           chunk=chunk, cache=jc)
        ty, tc = txl.mlstm(tw, _t(x[:, sl]), TC, num_heads=2, chunk=chunk,
                           cache=tc)
        _close(ty, jy, msg=str(sl))
        _tree_close(tc, jc)
    assert isinstance(tc["mlstm"], tuple) and len(tc["mlstm"]) == 3


def test_mlstm_rounds_the_scan_operands_to_bf16():
    """The chunk scan's products take bfloat16 operands, as the
    reference's: the one-step recurrence (all f32) differs from it by more
    than f32 rounding, and by less than the reference's own bf16 tolerance
    of 2e-2 (``tests/models/test_layers.py``)."""
    (_, tw), rng = _mlstm_case(10)
    x = rng.normal(size=(1, 6, 16)).astype(np.float32)
    scan, _ = txl.mlstm(tw, _t(x), TC, num_heads=2, chunk=6)
    c = {"mlstm": tuple(torch.zeros(s) for s in
                        ((1, 2, 16, 16), (1, 2, 16), (1, 2)))}
    steps = []
    for t in range(6):
        y, c = txl.mlstm(tw, _t(x[:, t:t + 1]), TC, num_heads=2, cache=c)
        steps.append(y)
    diff = float((torch.cat(steps, 1) - scan).abs().max())
    assert 1e-6 < diff
    _close(torch.cat(steps, 1), scan, 2e-2)


def test_slstm_matches_jax_and_carries_its_state():
    rng = np.random.default_rng(11)
    jp, _ = jxl.slstm_init(jax.random.PRNGKey(11), 16, 2)
    jw, tw = _both(_weights(jp, rng, 0.05))
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    jy, jc = jxl.slstm(jw, jnp.asarray(x), JC, num_heads=2)
    ty, tc = txl.slstm(tw, _t(x), TC, num_heads=2)
    _close(ty, jy)
    assert jc is None and tc is None
    z = np.zeros((2, 2, 8), np.float32)
    jc = {"slstm": tuple(jnp.asarray(z) for _ in range(4))}
    tc = {"slstm": tuple(_t(z) for _ in range(4))}
    for sl in (slice(0, 6), slice(6, 7), slice(7, 10)):
        jy, jc = jxl.slstm(jw, jnp.asarray(x[:, sl]), JC, num_heads=2,
                           cache=jc)
        ty, tc = txl.slstm(tw, _t(x[:, sl]), TC, num_heads=2, cache=tc)
        _close(ty, jy, msg=str(sl))
        _tree_close(tc, jc)


def test_slstm_init_opens_the_forget_gates():
    p = txl.slstm_init(Init(torch.Generator().manual_seed(0), (3,)), 8, 2)
    assert p["b_gates"].shape == (3, 32)
    assert torch.equal(p["b_gates"][:, 16:24], torch.full((3, 8), 3.0))
    assert float(p["b_gates"][:, :16].abs().sum()
                 + p["b_gates"][:, 24:].abs().sum()) == 0.0


# ---- cross-attention --------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_matches_jax(bias):
    rng = np.random.default_rng(12)
    jp, _ = jattn.attn_init(jax.random.PRNGKey(12), 32, 4, 4, 8,
                            qkv_bias=bias)
    jw, tw = _both(_weights(jp, rng, 0.1))
    enc = rng.normal(size=(2, 20, 32)).astype(np.float32)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    jkv = jattn.build_cross_kv(jw, jnp.asarray(enc), JC, num_kv_heads=4,
                               head_dim=8)
    tkv = tattn.build_cross_kv(tw, _t(enc), TC, num_kv_heads=4, head_dim=8)
    _tree_close(tkv, jkv)
    want = jattn.cross_attention(jw, jnp.asarray(x), jkv, JC, num_heads=4,
                                 num_kv_heads=4, head_dim=8)
    got = tattn.cross_attention(tw, _t(x), tkv, TC, num_heads=4,
                                num_kv_heads=4, head_dim=8)
    _close(got, want)
