"""``scan``, the reference's ``jax.lax.scan`` for a loop over time.

``scan(body, carry, xs, dim)`` runs ``carry, y = body(carry, x_t)`` for
each ``x_t = xs.select(dim, t)`` and stacks the ``y`` along ``dim``, as
the reference's sLSTM scans its gates over time.

On real tensors every step runs. On meta tensors (shapes only, as
``launch.dryrun`` runs a step) no value can differ from step to step, so a
scan of ``n > 3`` steps runs three: the first, one that stands for the
``n - 2`` in the middle, whose ``y`` is repeated, and the last (the first's
backward needs no gradient of the initial carry, the last's receives none
from a next step, every middle one both). The dry-run's xLSTM cells would
otherwise run every step's ops on the host: 32,768 steps a layer at
prefill_32k.

What the middle step stands for matters only to a tool that counts ops:
while one counts, it sets ``on_repeat`` (``launch.op_cost.OpCounter``),
and the middle step runs as ``on_repeat(n - 2, run, carry)``, ``run()``
being the step and ``carry`` what it was given. Nothing else reads it.
"""
from __future__ import annotations

import torch

on_repeat = None     # set by a counting tool while it counts


def scan(body, carry, xs: torch.Tensor, dim: int = 0):
    """``(carry, ys)``: ``body(carry, xs.select(dim, t)) -> (carry, y)``
    over every ``t``, the ``y`` stacked along ``dim``; on meta tensors three
    steps stand for all (the module's docstring)."""
    n = xs.shape[dim]
    if xs.device.type != "meta" or n <= 3:
        ys = []
        for t in range(n):
            carry, y = body(carry, xs.select(dim, t))
            ys.append(y)
        return carry, torch.stack(ys, dim)
    carry, first = body(carry, xs.select(dim, 0))
    prev = carry

    def run():
        return body(prev, xs.select(dim, 1))
    carry, mid = run() if on_repeat is None else on_repeat(n - 2, run, prev)
    carry, last = body(carry, xs.select(dim, n - 1))
    return carry, torch.stack([first] + [mid] * (n - 2) + [last], dim)
