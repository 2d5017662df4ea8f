"""Fault-tolerant training loop.

Port of ``repro/train/trainer.py`` with the reference's contract:
  - a deterministic pipeline keyed by step, and a checkpoint every k steps
    (``checkpoint.Checkpointer``: the params and the AdamW state);
  - on ANY step failure (an injected fault, a device error) the loop
    restores the latest checkpoint and replays from there, up to
    ``max_retries`` times: the final state is bit for bit that of an
    uninterrupted run;
  - SIGTERM sets a flag; the loop then saves a final blocking checkpoint
    and returns; a run that ends saves one too (where the last periodic
    checkpoint holds the final state, it waits for that write instead of
    writing the same file again);
  - a straggler watchdog: an EMA of the step's wall time, a step longer
    than ``straggler_factor`` x the EMA is counted.

A step ends with one host sync, the read of its loss (the reference's
``block_until_ready``), so a fault raised on the device surfaces inside
that step. On a CUDA device each step's device time is also taken with
CUDA events (``device_ms``).

On a mesh (``pctx=``, a ``core.parallel.ParallelContext``) every decision
is agreed before any rank acts on it, in one all-reduce of three flags
after each step (``ParallelContext.any_of``): a step that failed on any
rank is replayed on every rank, a SIGTERM on any rank stops every rank
before the next step, and a straggler step counts on every rank; the
checkpoints are the mesh's (``Checkpointer(pctx=)``). Otherwise one rank
would step while another waits in a collective until the group's timeout.
The metrics a step returns are whole on every rank
(``train_step.make_train_step(mesh=)``).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(self, tcfg: TrainerConfig, train_step: Callable,
                 pipeline, put_batch: Callable[[dict], dict], *, pctx=None):
        """train_step(params, opt, batch, step) -> (params, opt, metrics);
        put_batch places a host batch on the device (on a mesh, its
        DTensors)."""
        self.cfg = tcfg
        self.train_step = train_step
        self.pipeline = pipeline
        self.put_batch = put_batch
        self.pctx = pctx
        self.ckpt = Checkpointer(tcfg.checkpoint_dir, keep=tcfg.keep,
                                 pctx=pctx)
        self.step_times: list[float] = []
        self.device_ms: list[float] = []
        self.straggler_steps: list[int] = []
        self.retries = 0
        self._preempted = False
        self.fault_hook: Callable[[int], None] | None = None  # tests inject

    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None   # not the main thread (tests)

    def run(self, params: Any, opt_state: Any, start_step: int = 0,
            metrics_cb: Callable | None = None):
        previous = self._install_signal_handler()
        try:
            return self._run(params, opt_state, start_step, metrics_cb)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _any(self, *flags: bool) -> list[bool]:
        """Each flag true on every rank when it is true on some rank, all
        agreed in one all-reduce (the flags themselves without a mesh)."""
        if self.pctx is None:
            return list(flags)
        return self.pctx.any_of(flags)

    def _run(self, params, opt_state, start_step, metrics_cb):
        state = {"params": params, "opt": opt_state}

        # resume if a checkpoint exists
        latest = self.ckpt.latest_step()
        step = start_step
        if latest is not None and latest >= start_step:
            state = self.ckpt.restore(latest, state)
            step = latest

        ema, saved = None, None
        [preempted] = self._any(self._preempted)
        while step < self.cfg.total_steps:
            if preempted:
                self.ckpt.save(step, state, blocking=True)
                return state, step
            t0 = time.perf_counter()
            err = None
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.put_batch(self.pipeline.batch_at(step))
                events = None
                if any(isinstance(v, torch.Tensor) and v.is_cuda
                       for v in batch.values()):
                    events = [torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                    events[0].record()
                p, o, metrics = self.train_step(
                    state["params"], state["opt"], batch, step)
                if events is not None:
                    events[1].record()
                metrics["loss"].item()     # the one host sync a step
            except Exception as e:   # agreed below, then replayed or raised
                err = e
            dt = time.perf_counter() - t0
            # the step's one agreement: a fault, a straggler, and a SIGTERM
            # that stops the loop before the next step
            failed, slow, preempted = self._any(
                err is not None,
                err is None and ema is not None
                and dt > self.cfg.straggler_factor * ema,
                self._preempted)
            if failed:
                # fault path: restore + replay
                self.retries += 1
                if self.retries > self.cfg.max_retries:
                    if err is not None:
                        raise err
                    raise RuntimeError(f"step {step} failed on another rank "
                                       f"{self.retries} times")
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step
                    continue
                state = self.ckpt.restore(latest, state)
                step = latest
                continue
            state = {"params": p, "opt": o}

            self.step_times.append(dt)
            if events is not None:
                self.device_ms.append(events[0].elapsed_time(events[1]))
            if slow:
                self.straggler_steps.append(step)
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt

            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, state)
                saved = step
            if metrics_cb and step % self.cfg.log_every == 0:
                metrics_cb(step, {k: float(v) for k, v in metrics.items()})
        if saved == step:     # this very state is being written: wait for it
            self.ckpt.wait()
        else:
            self.ckpt.save(step, state, blocking=True)
        return state, step
