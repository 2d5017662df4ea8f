"""The port's fault-tolerant ``Trainer`` and ``launch/train.py`` on the CPU,
with the reference's contract (``tests/distributed/test_fault_tolerance.py``,
whose own tests are marked slow): a fault replays from the latest
checkpoint to the uninterrupted run's state bit for bit; a new trainer
resumes from a checkpoint to the same state; SIGTERM saves a blocking
checkpoint and returns; more faults than ``max_retries`` raise; a slow step
is counted as a straggler. The checkpoints are the JAX package's format:
its ``Checkpointer`` restores the port's trainer state.
"""
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

from _torch_train_common import models, port_params
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.optim import adamw as jadamw
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline, put_batch
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils.tree import tree_leaves


def _mk(tmp, total=12, ckpt_every=4, hook=None, **tcfg):
    """The reference test's trainer: llama3-8b reduced, f32, no remat,
    batches of 2 x 16 from seed 1, a checkpoint every 4 steps."""
    _, cfg, _, npp = models("llama3-8b")
    params = port_params(cfg, npp)
    pipe = SyntheticPipeline(DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                        batch=2, seq_len=16))
    step = make_train_step(cfg, compute_dtype=torch.float32, remat=False)
    tr = Trainer(TrainerConfig(total_steps=total, checkpoint_every=ckpt_every,
                               checkpoint_dir=str(tmp), keep=5, **tcfg),
                 step, pipe, lambda b: put_batch(b, "cpu"))
    tr.fault_hook = hook
    return tr, params, adamw.init(params)


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    tr, p, o = _mk(tmp_path_factory.mktemp("clean"))
    state, final = tr.run(p, o)
    assert final == 12 and tr.retries == 0
    return state


def test_failure_replay_is_bitwise_identical(tmp_path, clean):
    armed = {"on": True}

    def hook(step):
        if step == 9 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")

    tr, p, o = _mk(tmp_path, hook=hook)
    faulty, final = tr.run(p, o)
    assert tr.retries == 1 and final == 12
    assert _same(faulty, clean)


def test_resume_from_checkpoint(tmp_path, clean):
    tr, p, o = _mk(tmp_path, total=8)
    tr.run(p, o)
    tr, p, o = _mk(tmp_path, total=12)      # a new trainer, fresh weights
    resumed, final = tr.run(p, o)
    assert final == 12 and _same(resumed, clean)


def test_sigterm_saves_and_a_new_trainer_resumes(tmp_path, clean):
    before = signal.getsignal(signal.SIGTERM)

    def hook(step):
        if step == 6:
            os.kill(os.getpid(), signal.SIGTERM)   # the handler's flag

    tr, p, o = _mk(tmp_path, hook=hook)
    _, stopped = tr.run(p, o)
    assert stopped == 7 and tr.ckpt.latest_step() == 7
    assert signal.getsignal(signal.SIGTERM) is before
    tr, p, o = _mk(tmp_path)
    resumed, final = tr.run(p, o)
    assert final == 12 and _same(resumed, clean)


def test_more_faults_than_max_retries_raise(tmp_path):
    def hook(step):
        if step == 5:
            raise RuntimeError("persistent fault")

    tr, p, o = _mk(tmp_path, hook=hook, max_retries=2)
    with pytest.raises(RuntimeError, match="persistent fault"):
        tr.run(p, o)
    assert tr.retries == 3 and tr.ckpt.latest_step() == 4


def test_straggler_and_metrics_callback(tmp_path):
    slow = {"step": 6}

    def hook(step):
        if step == slow["step"]:
            slow["step"] = -1
            time.sleep(3.0)

    logged = []
    tr, p, o = _mk(tmp_path, total=10, hook=hook, straggler_factor=3.0,
                   log_every=5)
    tr.run(p, o, metrics_cb=lambda s, m: logged.append((s, m)))
    assert 6 in tr.straggler_steps and len(tr.step_times) == 10
    assert [s for s, _ in logged] == [5, 10]
    assert all(isinstance(v, float) for _, m in logged for v in m.values())
    assert sorted(logged[0][1]) == ["aux", "grad_norm", "loss", "nll", "ntok"]


def test_the_reference_restores_the_ports_checkpoint(tmp_path, clean):
    """``{"params", "opt"}`` as the port saves it restores in the JAX
    package's ``Checkpointer`` into the reference's own trees."""
    tr, p, o = _mk(tmp_path, total=4)
    state, _ = tr.run(p, o)
    jcfg, _, jp, _ = models("llama3-8b")
    like = {"params": jp, "opt": jadamw.init(jp)}
    back = JCheckpointer(str(tmp_path)).restore(4, like)
    want = [t.numpy() for t in tree_leaves(state)]
    got = [np.asarray(x) for x in jax.tree_util.tree_leaves(back)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_launcher_trains_the_reduced_config_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "llama3-8b", "--reduced", "--device",
                             "cpu", "--steps", "5", "--seq", "64",
                             "--batch", "2", "--log-every", "1",
                             "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 5 and len(out["losses"]) == 5
    assert all(np.isfinite(v) for _, v in out["losses"])
    assert out["device_ms"] == [] and len(out["step_s"]) == 5
    assert sorted(os.listdir(tmp_path)) == ["manifest.json",
                                            "step_00000005.npz"]
    assert "loss first->last" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--mesh", "2x4"], ["--production-mesh"],
                                  ["--multi-pod"]])
def test_launcher_refuses_a_mesh_naming_item_8a(flag):
    """The mesh flags build their mesh over the world: on a world of one
    rank ``build_mesh`` raises the ``ValueError`` that names the ranks the
    mesh needs, and no process group is left behind
    (``tests/test_torch_mesh_lm.py`` trains on a 2x2 mesh)."""
    import torch.distributed as dist
    ranks = {"--mesh": 8, "--production-mesh": 256, "--multi-pod": 512}[
        flag[0]]
    with pytest.raises(ValueError, match=f"needs {ranks} ranks; the world "
                                         "has 1"):
        launch_train.main(["--arch", "llama3-8b", "--reduced", "--device",
                           "cpu", *flag])
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without CUDA")
def test_launcher_runs_on_cuda_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama3-8b", "--reduced", "--steps",
                           "1"])
