"""``train.train_step`` of the port against the JAX package's on the CPU.

Three ``make_train_step`` steps (f32, no remat, the same cosine schedule
from each package's ``optim.adamw``) from the same bridged weights over the
same pipeline batches: the AdamW moments and every metric within f32
rounding of the reference's (rtol 1e-4, atol 1e-6; three configs: dense,
MoE with its aux loss, and the vlm frontend), and the params within 1e-4
relative or 5% of one learning rate: AdamW divides each gradient by its
own magnitude plus eps (1e-8), so an element whose gradient is near eps,
summed in another order, moves by a few percent of ``lr`` more or less. One bfloat16
mixed-precision step: the loss and grad norm at bfloat16 tolerance (2e-2)
and the params within two learning rates (a gradient near zero may take
either sign in bfloat16, and AdamW moves every element by up to ``lr``).
The step writes the params and moments it is given, and remat gives the
same bits as no remat; the serve and prefill factories are the model's
functions; a mesh is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import models, port_params
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as TM
from repro_torch.models.common import Ctx
from repro_torch.optim import adamw
from repro_torch.train import train_step as tts
from repro_torch.utils.tree import tree_leaves

LR = 1e-3


def _data(cfg, batch=2, seq=32, seed=2):
    dc = dict(seed=seed, vocab_size=cfg.vocab_size, batch=batch,
              seq_len=seq, frontend_seq=cfg.frontend_seq if cfg.frontend
              else 0, d_model=cfg.d_model)
    return jpipe.SyntheticPipeline(jpipe.DataConfig(**dc))


def _run_both(arch, steps, compute, remat=False):
    jcfg, tcfg, jp, npp = models(arch)
    pipe = _data(jcfg)
    jstep = jax.jit(jts.make_train_step(
        jcfg, None, compute_dtype=compute[0], remat=remat,
        lr_schedule=jadamw.cosine_schedule(LR, 0, 10)))
    tstep = tts.make_train_step(
        tcfg, compute_dtype=compute[1], remat=remat,
        lr_schedule=adamw.cosine_schedule(LR, 0, 10))
    jo = jadamw.init(jp)
    tp = port_params(tcfg, npp)
    to = adamw.init(tp)
    out = []
    for step in range(steps):
        b = pipe.batch_at(step)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.int32(step))
        tp, to, tm = tstep(tp, to, tpipe.put_batch(b, "cpu"), step)
        out.append((jm, tm))
    return (jp, jo), (tp, to), out


def _close(got_tree, want_tree, rtol, atol):
    got = [t.detach().numpy() for t in tree_leaves(got_tree)]
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b"])
def test_three_f32_steps_match_the_reference(arch):
    (jp, jo), (tp, to), metrics = _run_both(
        arch, 3, (jnp.float32, torch.float32))
    for jm, tm in metrics:
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    _close(tp, jp, 1e-4, 0.05 * LR)
    _close(to["m"], jo["m"], 1e-4, 1e-6)
    _close(to["v"], jo["v"], 1e-4, 1e-9)
    assert int(to["count"]) == int(jo["count"]) == 3


def test_a_bf16_mixed_precision_step_matches_at_bf16_tolerance():
    (jp, _), (tp, to), [(jm, tm)] = _run_both(
        "llama3-8b", 1, (jnp.bfloat16, torch.bfloat16), remat=True)
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-2,
                                   err_msg=k)
    # f32 masters, stepped by at most lr a step either way
    assert all(t.dtype == torch.float32 for t in tree_leaves((tp, to["m"])))
    _close(tp, jp, 0.0, 2 * LR + 1e-6)


def test_the_step_updates_in_place_and_remat_gives_the_same_bits():
    """Two f32 steps of the MoE config (aux loss) with remat and without:
    each step returns the params and moments it was given, written in
    place, and both runs end on the same bits."""
    _, tcfg, _, npp = models("granite-moe-1b-a400m")
    pipe = tpipe.SyntheticPipeline(tpipe.DataConfig(
        seed=4, vocab_size=tcfg.vocab_size, batch=2, seq_len=32))
    kw = dict(compute_dtype=torch.float32,
              lr_schedule=adamw.cosine_schedule(LR, 0, 10))
    rm, plain = (tts.make_train_step(tcfg, remat=r, **kw)
                 for r in (True, False))
    p0 = port_params(tcfg, npp)
    keep = [t.clone() for t in tree_leaves(p0)]
    pr, orr = p0, adamw.init(p0)
    pp = port_params(tcfg, npp)
    op = adamw.init(pp)
    for step in range(2):
        b = tpipe.put_batch(pipe.batch_at(step), "cpu")
        given = tree_leaves((pr, orr["m"], orr["v"]))
        pr, orr, mr = rm(pr, orr, b, step)
        assert all(x is y for x, y in zip(
            tree_leaves((pr, orr["m"], orr["v"])), given))
        pp, op, mp = plain(pp, op, b, step)
        assert torch.equal(mr["loss"], mp["loss"])
        assert torch.equal(mr["grad_norm"], mp["grad_norm"])
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(pr), keep))
    for x, y in zip(tree_leaves((pr, orr)), tree_leaves((pp, op))):
        assert torch.equal(x, y)


def test_serve_and_prefill_steps_are_the_models_functions():
    _, tcfg, _, npp = models("llama3-8b")
    tp = port_params(tcfg, npp)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    ctx = Ctx(compute_dtype=torch.float32)
    prefill = tts.make_prefill(tcfg, max_seq=24, compute_dtype=torch.float32)
    serve = tts.make_serve_step(tcfg, compute_dtype=torch.float32)
    logits, caches, cross = prefill(tp, tok)
    want = TM.prefill(tp, tok, ctx, tcfg, max_seq=24)
    assert torch.equal(logits, want[0]) and cross is None
    nxt = logits.argmax(-1).to(torch.int32)
    got, _ = serve(tp, nxt, caches)
    want2, _ = TM.decode_step(tp, nxt, want[1], ctx, tcfg)
    assert torch.equal(got, want2) and not got.requires_grad


@pytest.mark.parametrize("factory", ["make_train_step", "make_serve_step",
                                     "make_prefill"])
def test_a_mesh_is_refused_naming_item_8a(factory):
    """Each factory takes a mesh: on a 1x1 mesh (params, batch and caches
    as DTensors) its step gives the one-device step's numbers (a train
    step's metrics and params, the prefill's and a decode step's logits);
    ``tests/test_torch_mesh_lm.py`` runs them on 4 ranks."""
    from _torch_train_common import mesh_of_one
    from repro_torch.utils import sharding as shd
    _, tcfg, _, npp = models("llama3-8b")
    f32 = {"compute_dtype": torch.float32}
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32))
    with mesh_of_one() as mesh:
        placed = shd.place_tree(port_params(tcfg, npp), TM.model_specs(tcfg),
                                mesh)
        tok_m = shd.place(tok, mesh, shd.placements(("data",), mesh))
        if factory == "make_train_step":
            b = _data(tcfg).batch_at(0)
            one = port_params(tcfg, npp)
            lr = adamw.cosine_schedule(LR, 0, 10)
            want = tts.make_train_step(tcfg, lr_schedule=lr, **f32)(
                one, adamw.init(one), tpipe.put_batch(b, "cpu"), 0)
            got = tts.make_train_step(tcfg, mesh, lr_schedule=lr, **f32)(
                placed, adamw.init(placed),
                tpipe.put_batch(b, "cpu", mesh=mesh), 0)
            for k, v in want[2].items():
                assert not shd.is_dtensor(got[2][k])
                np.testing.assert_allclose(float(got[2][k]), float(v),
                                           rtol=1e-5)
            for g, w in zip(tree_leaves(got[0]), tree_leaves(want[0])):
                np.testing.assert_allclose(shd.gather(g).numpy(), w.numpy(),
                                           rtol=1e-5, atol=1e-7)
            return
        prefill = tts.make_prefill(tcfg, mesh, max_seq=12, **f32)
        want = tts.make_prefill(tcfg, max_seq=12, **f32)(
            port_params(tcfg, npp), tok)
        logits, caches, _ = prefill(placed, tok_m)
        if factory == "make_prefill":
            np.testing.assert_allclose(shd.gather(logits).numpy(),
                                       want[0].numpy(), rtol=1e-5,
                                       atol=1e-5)
            return
        nxt = want[0].argmax(-1).to(torch.int32)
        one, _ = tts.make_serve_step(tcfg, **f32)(
            port_params(tcfg, npp), nxt, want[1])
        got, _ = tts.make_serve_step(tcfg, mesh, **f32)(
            placed, shd.place(nxt, mesh, shd.placements(("data",), mesh)),
            caches)
        np.testing.assert_allclose(shd.gather(got).numpy(), one.numpy(),
                                   rtol=1e-5, atol=1e-5)
