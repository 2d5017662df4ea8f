"""The device rescore cache's batched insert: second-chance/clock eviction.

The kernel is ``csrc/rescore_cache.cu`` (CUDA C++ for sm_90a); it replaces
the sequential ``fori_loop`` of ``_cache_insert`` in
``repro/index/rescore_cache.py`` (l.99-146), which is XLA, not a Pallas
kernel. Item ``i`` of that loop touches only set ``id % sets``, so the loop
is exactly "for each set, its items in batch order": ``group_by_set``
sorts the batch by set once (stable, on the device, no host read) and the
kernel runs one warp per set that has items (``csrc/rescore_cache.cu`` has
the rules).

``cache_insert_raw(keys, rows, ref, hand, ids, x)`` updates the table in
place: ``keys`` (S, W) int32 (-1 empty), ``rows`` (S, W, d) f32, ``ref``
(S, W) int32, ``hand`` (S,) int32; ``ids`` (m,) int32 (-1 skips), ``x`` (m,
d) f32. CPU tensors go to ``cache_insert_plain``, which takes the same
grouping in rounds (round ``j``: each set's ``j``-th item, vectorized over
sets); CUDA tensors launch the kernel or raise. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0   # kernel launches (CUDA only); reset by callers that count
MAX_WAYS = 32  # a set's lanes live in one warp


def _check(keys, rows, ref, hand, ids, x) -> None:
    who = "rescore_cache insert"
    if keys.ndim != 2 or keys.dtype != torch.int32:
        raise TypeError(f"{who}: keys must be (S, W) int32, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    s, w = keys.shape
    if not 1 <= w <= MAX_WAYS:
        raise ValueError(f"{who}: ways={w} must lie in [1, {MAX_WAYS}] (a "
                         f"set's lanes live in one warp)")
    d = rows.shape[-1] if rows.ndim == 3 else -1
    want = {"rows": (rows, (s, w, d), torch.float32),
            "ref": (ref, (s, w), torch.int32),
            "hand": (hand, (s,), torch.int32),
            "ids": (ids, (ids.shape[0],), torch.int32),
            "x": (x, (ids.shape[0], d), torch.float32)}
    for name, (t, shape, dt) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{who}: {name} must be {dt} {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != keys.device:
            raise ValueError(f"{who}: {name} on {t.device}, keys on "
                             f"{keys.device}")
    for name, t in (("keys", keys), ("rows", rows), ("ref", ref),
                    ("hand", hand)):
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous (it is "
                             f"updated in place)")
    if s * w >= 2**31 or ids.shape[0] >= 2**31 or d >= 2**31:
        raise ValueError(f"{who}: sizes must fit int32")


def group_by_set(ids: torch.Tensor, sets: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch grouped by set: ``order`` (m,) int32, the items sorted by
    ``id % sets`` (stable: batch order within a set), and ``seg`` (sets +
    1,) int32, set ``s``'s items being ``order[seg[s]:seg[s + 1]]``. Ids of
    -1 sort past the last set."""
    s = torch.where(ids >= 0, ids % sets, sets)
    s_sorted, order = torch.sort(s, stable=True)
    seg = torch.searchsorted(
        s_sorted, torch.arange(sets + 1, dtype=s_sorted.dtype,
                               device=ids.device))
    return order.to(torch.int32), seg.to(torch.int32)


def cache_insert_plain(keys, rows, ref, hand, ids, x, order, seg) -> None:
    """Plain PyTorch version, in place: round ``j`` applies each set's
    ``j``-th item of the grouping, vectorized over sets, with the
    reference's rules (hit, first empty lane, clock sweep from ``hand``).
    The number of rounds is a host read."""
    ways = keys.shape[1]
    cnt = seg[1:] - seg[:-1]
    lanes = torch.arange(ways, device=keys.device)
    rounds = int(cnt.max()) if cnt.numel() else 0
    for j in range(rounds):
        s = torch.nonzero(cnt > j).squeeze(1)
        item = order[(seg[s] + j).long()].long()
        idv = ids[item]
        lane = keys[s]
        match = lane == idv.unsqueeze(1)
        hit = match.any(1)
        empty = lane < 0
        has_empty = empty.any(1)
        h = hand[s].long()
        clock = (h.unsqueeze(1) + lanes) % ways        # lane at each step
        ref_s = ref[s]
        refs_o = torch.gather(ref_s, 1, clock)
        zero = refs_o == 0
        anyz = zero.any(1)
        first = zero.int().argmax(1)
        vpos = torch.where(anyz, first, ways)
        victim = torch.gather(clock, 1, torch.where(anyz, first, 0)
                              .unsqueeze(1)).squeeze(1)
        cleared = torch.scatter(ref_s, 1, clock, torch.where(
            lanes < vpos.unsqueeze(1), 0, refs_o))
        evict = ~hit & ~has_empty
        way = torch.where(hit, match.int().argmax(1),
                          torch.where(has_empty, empty.int().argmax(1),
                                      victim))
        ref_row = torch.where(evict.unsqueeze(1), cleared, ref_s)
        ref_row[torch.arange(s.numel(), device=keys.device), way] = 1
        keys[s, way] = idv
        rows[s, way] = x[item]
        ref[s] = ref_row
        hand[s] = torch.where(evict, (victim + 1) % ways, h).to(torch.int32)


def cache_insert_raw(keys: torch.Tensor, rows: torch.Tensor,
                     ref: torch.Tensor, hand: torch.Tensor,
                     ids: torch.Tensor, x: torch.Tensor) -> None:
    """Insert ``(ids, x)`` into the table in batch order, in place."""
    global launches
    _check(keys, rows, ref, hand, ids, x)
    if ids.shape[0] == 0:
        return
    sets, ways = keys.shape
    order, seg = group_by_set(ids, sets)
    if keys.device.type == "cpu":
        cache_insert_plain(keys, rows, ref, hand, ids, x, order, seg)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"rescore_cache insert: unsupported device "
                         f"{keys.device}")
    ids, x = ids.contiguous(), x.contiguous()
    d = rows.shape[2]
    vec = int(d % 4 == 0 and x.data_ptr() % 16 == 0
              and rows.data_ptr() % 16 == 0)
    code = _build.lib().fk_rescore_cache_insert(
        keys.data_ptr(), rows.data_ptr(), ref.data_ptr(), hand.data_ptr(),
        ids.data_ptr(), x.data_ptr(), order.data_ptr(), seg.data_ptr(),
        sets, ways, d, vec, _build.stream_ptr(keys.device))
    _build.check(code, "rescore_cache insert kernel launch")
    launches += 1
