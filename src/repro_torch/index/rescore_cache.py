"""Device-resident exact-rescore row cache for quantized bucket stores.

Port of ``repro/index/rescore_cache.py``. The q8 search
proposes top-``R`` ids from int8 codes and rescores them against exact
fp32 rows; with the host ``RescoreReservoir`` that needs the ids on the
host, a dictionary lookup and the rows sent back before the rescore can
launch. ``DeviceRescoreCache`` keeps the rows in device memory, a
set-associative id -> fp32-row table (ref. l.1-46), in ``shards`` regions
of ``sets`` sets (one on one device):

- ``keys``  int32 ``(shards * sets, ways)`` id lanes, ``-1`` = empty;
- ``rows``  fp32  ``(shards * sets, ways, d)`` row pool;
- ``ref``   int32 ``(shards * sets, ways)`` second-chance bits;
- ``hand``  int32 ``(shards * sets,)`` per-set clock hand.

Ids are dense (``IVFIndex._append`` allocates them in order), so the set
is ``id % sets``. Unbounded (``max_bytes=None``) the table grows until
``sets * ways > max_id``, which keeps every id resident: the device path
then returns the host path's ids and distances bit for bit. Under a byte
budget the capacity is fixed and the clock evicts; a miss rescores the
decoded q8 row, the reservoir's spill contract.

Inserts (``put``) run at ``add``/build cadence through the hand-written
kernel ``kernels/rescore_cache.py`` (``csrc/rescore_cache.cu``); lookups
(``cache_lookup``) are plain PyTorch gathers that make no host read.
``REPRO_RESCORE`` picks the process default: ``device`` (this cache) or
``host`` (the reservoir round trip, kept as the parity oracle).

On a mesh the cache is split over the cells axis beside the codes
(``place``, ``shard_specs``): region ``s`` holds the ids whose home cell
K-shard ``s`` owns (``put(shard=)``, fixed at append time), and a rank keeps
only its own region, ``(sets, ways)``, which ``cache_lookup`` and the insert
kernel address as a whole table (set ``id % sets``). ``sets`` is sized for
the global ids, so a region never conflicts past ``ways`` where one table
would not.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.kmeans import resolve_device
from repro_torch.kernels import rescore_cache as _kernel

__all__ = ["DeviceRescoreCache", "RESCORE_KINDS", "default_rescore_kind",
           "cache_lookup"]

RESCORE_KINDS = ("device", "host")

# bytes a cached row: the fp32 payload plus the id/ref bookkeeping, as the
# reservoir counts it, so both tiers read rescore_bytes the same way
_ROW_OVERHEAD = 8

def default_rescore_kind() -> str:
    """The process default rescore-row source of quantized stores
    (ref. l.67-74): ``REPRO_RESCORE``, else ``"device"``."""
    kind = os.environ.get("REPRO_RESCORE", "device").strip().lower()
    if kind not in RESCORE_KINDS:
        raise ValueError(
            f"REPRO_RESCORE={kind!r}: expected one of {RESCORE_KINDS}")
    return kind


def _pow2ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def cache_lookup(keys: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched gather (ref. l.81-96): ``ids`` (any shape, int32, -1 dead)
    -> ``(rows ids.shape + (d,) f32, found ids.shape bool)``; misses and
    dead ids read zero rows. The set's key lanes, a compare, then the
    matched row: no host read."""
    sets = keys.shape[0]
    live = ids >= 0
    s = (torch.where(live, ids, 0) % sets).long()
    match = (keys[s] == ids.unsqueeze(-1)) & live.unsqueeze(-1)
    found = match.any(-1)
    way = match.to(torch.uint8).argmax(-1)
    out = rows[s, way]
    return torch.where(found.unsqueeze(-1), out, 0.0), found


class DeviceRescoreCache:
    """Set-associative device id -> fp32-row table (ref. l.149-290).
    ``max_bytes=None`` (the reservoir's convention) grows to hold every
    id; a byte budget fixes the capacity and evicts second-chance/clock.
    ``device=None`` means ``"cuda"``."""

    def __init__(self, d: int, *, max_bytes: int | None = None,
                 ways: int = 4, shards: int = 1, init_sets: int = 64,
                 device=None):
        self.d = int(d)
        self.ways = int(ways)
        self.shards = max(1, int(shards))
        self.max_bytes = max_bytes
        self.device = resolve_device(device)
        if max_bytes is None:
            sets = _pow2ceil(init_sets)
        else:
            cap_rows = max(1, int(max_bytes) // (4 * self.d + _ROW_OVERHEAD))
            sets = _pow2ceil(max(1, cap_rows // (self.ways * self.shards)))
        self.sets = sets
        self.inserted = 0      # rows put (ids are unique -> distinct ids)
        # the regions this device holds: (first shard, count), all until
        # ``place``
        self._held = (0, self.shards)
        self._alloc()

    def _alloc(self) -> None:
        kw = {"device": self.device}
        rows = self._held[1] * self.sets
        self.keys = torch.full((rows, self.ways), -1, dtype=torch.int32, **kw)
        self.rows = torch.zeros((rows, self.ways, self.d),
                                dtype=torch.float32, **kw)
        self.ref = torch.zeros((rows, self.ways), dtype=torch.int32, **kw)
        self.hand = torch.zeros((rows,), dtype=torch.int32, **kw)

    @property
    def capacity(self) -> int:
        """Row slots of the table, over all shards."""
        return self.shards * self.sets * self.ways

    @property
    def evicted(self) -> int:
        """Lower bound on clock evictions (exact for the dense unique-id
        stream every index produces)."""
        return max(0, self.inserted - self.capacity)

    def fingerprint(self) -> tuple:
        """Geometry key for plan caches: growth changes the table shape."""
        return (self.sets, self.ways)

    def device_arrays(self) -> tuple:
        """The tensors the search's lookup reads: ``(keys, rows)``."""
        return (self.keys, self.rows)

    def shard_specs(self, ka) -> tuple:
        """The split of ``device_arrays()`` over the cells axis ``ka``."""
        return ((ka, None), (ka, None, None))

    def place(self, pctx) -> None:
        """Keep only this rank's region under ``pctx``'s ``k_axis`` (ref.
        l.265-273), cut without communication. The cache must have as many
        shards as the axis; a context without a ``k_axis`` leaves it
        whole."""
        if pctx.k_axis is None or self._held == (pctx.k_rank, 1):
            return
        if pctx.n_k_shards != self.shards or self._held[1] != self.shards:
            raise ValueError(f"a cache of {self.shards} shards (holding "
                             f"{self._held[1]}) on a {pctx.n_k_shards}-way "
                             f"cells axis")
        s = pctx.k_rank
        own = slice(s * self.sets, (s + 1) * self.sets)
        self.keys = self.keys[own].contiguous()
        self.rows = self.rows[own].contiguous()
        self.ref = self.ref[own].contiguous()
        self.hand = self.hand[own].contiguous()
        self._held = (s, 1)

    # ------------------------------------------------------------------
    def _grow(self, sets: int) -> None:
        """Rehash each held region to ``sets``, a power-of-two multiple of
        the current count, in one step (ref. l.204-226 doubles one step at a
        time): new set ``s'`` takes old set ``s' % S``'s lanes whose id lands
        in ``s'``, their ref bits and the old set's hand and row pool. That
        is what the doublings give, rows of empty lanes included."""
        h, dev = self._held[1], self.device
        new = torch.arange(sets, device=dev)
        src = (torch.arange(h, device=dev).unsqueeze(1) * self.sets
               + new % self.sets).reshape(-1)
        k = self.keys[src]
        keep = (k >= 0) & (k % sets == new.repeat(h).to(k.dtype).unsqueeze(1))
        self.keys = torch.where(keep, k, -1)
        self.ref = torch.where(keep, self.ref[src], 0)
        self.rows = self.rows[src]
        self.hand = self.hand[src]
        self.sets = sets

    def _ensure(self, max_id: int) -> None:
        sets = self.sets
        while sets * self.ways <= max_id:
            sets *= 2
        if sets != self.sets:
            self._grow(sets)

    # ------------------------------------------------------------------
    def put(self, ids, rows, shard=None) -> None:
        """Batched insert at host cadence (``add``, build, restore; never
        the search path), in batch order. ``ids`` (numpy or a tensor; -1
        skips), ``rows`` (m, d), a tensor on the cache's device needs no
        copy. ``shard``: each row's home K-shard (``cell // (K /
        shards)``, host ints; None: shard 0); a placed cache inserts its own
        shard's rows only. The growth check reads the whole batch's
        ``max(ids)`` on the host, so every rank grows alike."""
        if isinstance(ids, torch.Tensor):
            ids_t = ids.reshape(-1).to(device=self.device, dtype=torch.int32)
            top = lambda: int(ids_t.max())
        else:
            ids_np = np.asarray(ids, np.int64).reshape(-1)
            ids_t = torch.as_tensor(ids_np.astype(np.int32),
                                    device=self.device)
            top = lambda: int(ids_np.max())
        m = ids_t.shape[0]
        if m == 0:
            return
        if self.max_bytes is None:
            self._ensure(top())
        x = torch.as_tensor(rows).to(device=self.device,
                                     dtype=torch.float32).reshape(m, self.d)
        sh = np.zeros(m, np.int64) if shard is None \
            else np.asarray(shard, np.int64).reshape(-1)
        s0, h = self._held
        for s in range(s0, s0 + h):
            sel = sh == s
            if not sel.any():
                continue
            ids_s, x_s = ids_t, x
            if not sel.all():
                pick = torch.as_tensor(np.flatnonzero(sel), device=self.device)
                ids_s, x_s = ids_t[pick], x[pick]
            region = slice((s - s0) * self.sets, (s - s0 + 1) * self.sets)
            _kernel.cache_insert_raw(self.keys[region], self.rows[region],
                                     self.ref[region], self.hand[region],
                                     ids_s, x_s)
        self.inserted += m

    def lookup(self, ids) -> tuple[torch.Tensor, torch.Tensor]:
        """``cache_lookup`` over the table (tests and host-side probes)."""
        ids = torch.as_tensor(ids).to(device=self.device, dtype=torch.int32)
        return cache_lookup(self.keys, self.rows, ids)

    def meta(self) -> dict:
        """Snapshot manifest entry (ref. l.275-280): the row pool is never
        serialized; restore re-warms it from the host reservoir."""
        return {"kind": "device", "ways": self.ways,
                "max_bytes": self.max_bytes, "sets": self.sets,
                "inserted": int(self.inserted)}

    def resident_bytes(self) -> int:
        return 4 * (self.keys.numel() + self.rows.numel() + self.ref.numel()
                    + self.hand.numel())

    def __repr__(self) -> str:
        return (f"DeviceRescoreCache(d={self.d}, sets={self.sets}, "
                f"ways={self.ways}, shards={self.shards}, "
                f"inserted={self.inserted}, "
                f"max_bytes={self.max_bytes}, device={self.device})")
