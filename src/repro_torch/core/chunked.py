"""Out-of-core chunked k-means: host chunks streamed through the card.

Port of ``repro/core/chunked.py`` (paper §4.3). When the dataset does not
fit in device memory, each Lloyd iteration streams it from the host in
chunks and reduces every chunk to a ``SufficientStats`` (sums, counts,
inertia: O(K d)), so the device holds two chunk slots and the statistics,
whatever N is. The reference overlaps transfer and compute through JAX's
asynchronous dispatch; on the card ``ChunkedKMeans`` does it explicitly:

- **staging**: two device slots of ``chunk_size`` rows, allocated once; a
  ragged tail chunk uses a view of its slot. A chunk that is a pinned CPU
  tensor is copied from its own memory. A numpy array or a pageable tensor
  is first copied into one of two pinned host buffers (allocated once, at
  the first such chunk); that host copy is timed apart
  (``ChunkedStats.staging_seconds``);
- **two streams**: the host-to-device copy of chunk i+1 runs on a side copy
  stream while chunk i's kernels run on the current stream. The copy into a
  slot waits for the event recorded after the last launch that read it; the
  kernels wait for their chunk's copy event; the host waits for a slot's
  previous copy before it refills that slot's pinned buffer or pulls the
  chunk that will go there from the source (so a source may reuse a chunk's
  memory two chunks later);
- **timing**: ``h2d_seconds`` and ``compute_seconds`` come from CUDA events
  on the two streams around each warm chunk (one whose row count was
  stepped before: the first chunk of a shape plans, and at the first call
  builds the kernels), read once after the iteration's final
  synchronisation.

On the CPU there are no streams and no pinned memory: the plain path slices
and steps, timed by ``time.perf_counter``. ``device=None`` means
``"cuda"`` and raises without a CUDA device.

Exactness: the statistics are summed in f32 across chunks, so an iteration
is a Lloyd iteration over the whole dataset, its ids those of the in-core
step and its sums equal up to the order of the f32 additions.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.kmeans import KMeansConfig, resolve_device
from repro_torch.core.streaming import SufficientStats


@dataclasses.dataclass
class ChunkedStats:
    """Telemetry of the pipeline, summed over iterations.

    On the card ``h2d_seconds`` and ``compute_seconds`` are device times
    from CUDA events (the copy stream's copy, the compute stream's launches)
    over the ``sampled_chunks`` warm chunks; ``staging_seconds`` is the host
    clock of copying pageable chunks into pinned memory. ``dispatch_*`` are
    the host clock of issuing the copies and the launches, which return
    before the device runs them: enqueue cost, never transfer or compute
    time. ``wall_seconds`` runs from the first chunk to the synchronised
    centroids. On the CPU ``compute_seconds`` is the host clock around each
    warm chunk's step, and the copy fields stay 0.
    """
    h2d_seconds: float = 0.0
    compute_seconds: float = 0.0
    sampled_chunks: int = 0
    staging_seconds: float = 0.0
    dispatch_h2d_seconds: float = 0.0
    dispatch_compute_seconds: float = 0.0
    wall_seconds: float = 0.0
    chunks: int = 0


def _host_tensor(chunk, rows: int, d: int) -> torch.Tensor:
    """A chunk of at most ``rows`` rows of width ``d`` as a host tensor,
    without copying a numpy array; float64 becomes float32 (as
    ``jnp.asarray`` makes it)."""
    t = chunk if isinstance(chunk, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(chunk))
    if t.device.type != "cpu":
        raise ValueError(f"ChunkedKMeans streams host chunks; got a chunk "
                         f"on {t.device}")
    if t.ndim != 2 or t.shape[0] > rows or t.shape[1] != d:
        raise ValueError(f"chunk of shape {tuple(t.shape)}: at most "
                         f"chunk_size={rows} rows of width {d}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t


def _pinned_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class ChunkedKMeans:
    """Exact Lloyd iterations over a dataset streamed in chunks.

    ``data`` is a host numpy array or CPU tensor (sliced into chunks of
    ``chunk_size`` rows), or a factory ``() -> Iterator`` of either, each
    chunk at most ``chunk_size`` rows (the tail may be smaller).

    ``sample_every`` is taken for the reference's signature and ignored:
    the reference times one chunk in ``sample_every`` on the host, the port
    times every warm chunk with CUDA events on both streams.
    """

    def __init__(self, cfg: KMeansConfig, chunk_size: int,
                 sample_every: int = 8, *, device=None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.cfg = cfg
        self.chunk_size = int(chunk_size)
        self.device = resolve_device(device)
        self.stats = ChunkedStats()
        self.last_stats: SufficientStats | None = None
        self.iters_run = 0
        self._stepped: set[tuple] = set()
        self._slots: torch.Tensor | None = None   # (2, chunk_size, d) device
        self._pinned: torch.Tensor | None = None  # (2, chunk_size, d) host
        self._copy_stream = None
        self._held: list = []

    def _chunks(self, data) -> Iterator:
        if callable(data):
            yield from data()
            return
        for lo in range(0, data.shape[0], self.chunk_size):
            yield data[lo:lo + self.chunk_size]

    def iterate(self, data, c: torch.Tensor, *,
                assignments: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """One full Lloyd iteration over all chunks: ``(c_new, inertia)``.

        The merged statistics stay readable as ``self.last_stats``.
        ``assignments``, an (N,) int32 tensor, receives each chunk's ids at
        its rows' offsets.
        """
        c = torch.as_tensor(c).to(self.device)
        t_wall = time.perf_counter()
        run = (self._iterate_cuda if self.device.type == "cuda"
               else self._iterate_plain)
        stats, events = run(self._chunks(data), c, assignments)
        self.last_stats = stats
        c_new = stats.finalize(c)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for h0, h1, k0, k1 in events:   # the card's warm chunks
            self.stats.h2d_seconds += h0.elapsed_time(h1) * 1e-3
            self.stats.compute_seconds += k0.elapsed_time(k1) * 1e-3
        self.stats.sampled_chunks += len(events)
        self.stats.wall_seconds += time.perf_counter() - t_wall
        return c_new, stats.inertia

    def _step(self, x: torch.Tensor, c: torch.Tensor, stats, out, row):
        """Fold one device-resident chunk into ``stats``; the planner's
        lookup is a cache hit after the first chunk of a shape bucket."""
        if self.cfg.dtype is not None:
            x = x.to(self.cfg.dtype)
        n, d = x.shape
        blk = self.cfg.blocks_for(n, d, x.element_size(), x.device)
        part, a = SufficientStats.from_batch(x, c.to(x.dtype), self.cfg,
                                             blk=blk)
        if out is not None:
            out[row:row + n].copy_(a, non_blocking=True)
        return stats.merge(part)

    def _iterate_plain(self, chunks, c, out):
        stats = SufficientStats.zero(self.cfg.k, c.shape[1], self.device)
        row = 0
        for chunk in chunks:
            x = _host_tensor(chunk, self.chunk_size, c.shape[1])
            warm = tuple(x.shape) in self._stepped
            self._stepped.add(tuple(x.shape))
            t0 = time.perf_counter()
            stats = self._step(x, c, stats, out, row)
            if warm:
                self.stats.compute_seconds += time.perf_counter() - t0
                self.stats.sampled_chunks += 1
            self.stats.chunks += 1
            row += x.shape[0]
        return stats, []

    def _iterate_cuda(self, chunks, c, out):
        dev, d = self.device, c.shape[1]
        comp = torch.cuda.current_stream(dev)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        copy = self._copy_stream
        stats = SufficientStats.zero(self.cfg.k, d, dev)
        copied = [None, None]     # the last H2D into slot s (event)
        consumed = [None, None]   # after the last launch reading slot s
        held = [None, None]       # the pinned source of slot s's copy,
        self._held = held         # alive until the next iteration
        timed = []
        row, j = 0, 0
        while True:
            s = j % 2
            if copied[s] is not None:
                copied[s].synchronize()   # slot s's pinned source is free
                held[s] = None
            chunk = next(chunks, None)
            if chunk is None:
                break
            src = _host_tensor(chunk, self.chunk_size, d)
            n = src.shape[0]
            if j == 0 and (self._slots is None or self._slots.shape[2] != d
                           or self._slots.dtype != src.dtype):
                # between iterations only: the last one ended synchronised
                self._slots = torch.empty((2, self.chunk_size, d),
                                          dtype=src.dtype, device=dev)
            elif src.dtype != self._slots.dtype:
                raise ValueError(f"chunk {j} is {src.dtype}, the first "
                                 f"{self._slots.dtype}: one type a pass")
            if not src.is_pinned():
                if (self._pinned is None or self._pinned.shape[2] != d
                        or self._pinned.dtype != src.dtype):
                    self._pinned = _pinned_empty((2, self.chunk_size, d),
                                                 src.dtype)
                t0 = time.perf_counter()
                src = self._pinned[s, :n].copy_(src)
                self.stats.staging_seconds += time.perf_counter() - t0
            held[s] = src
            slot = self._slots[s, :n]
            warm = (n, d) in self._stepped
            self._stepped.add((n, d))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t0 = time.perf_counter()
            if consumed[s] is not None:
                copy.wait_event(consumed[s])
            ev[0].record(copy)
            with torch.cuda.stream(copy):
                slot.copy_(src, non_blocking=True)
            ev[1].record(copy)
            copied[s] = ev[1]
            t1 = time.perf_counter()
            comp.wait_event(ev[1])
            ev[2].record(comp)
            stats = self._step(slot, c, stats, out, row)
            ev[3].record(comp)
            consumed[s] = ev[3]
            self.stats.dispatch_h2d_seconds += t1 - t0
            self.stats.dispatch_compute_seconds += time.perf_counter() - t1
            if warm:
                timed.append(ev)
            self.stats.chunks += 1
            row += n
            j += 1
        return stats, timed

    def fit(self, data, c0: torch.Tensor, iters: int | None = None,
            tol: float | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Lloyd iterations, stopping once the squared centroid shift is at
        most ``tol`` (default ``cfg.tol``), as ``make_kmeans_fn`` does; the
        iterations run are ``self.iters_run``. One host read a step."""
        tol = self.cfg.tol if tol is None else tol
        c = torch.as_tensor(c0).to(self.device)
        inertia = torch.tensor(float("inf"), device=self.device)
        self.iters_run = 0
        for _ in range(iters if iters is not None else self.cfg.max_iters):
            c_new, inertia = self.iterate(data, c)
            shift = float(((c_new.float() - c.float()) ** 2).sum())
            c = c_new
            self.iters_run += 1
            if shift <= tol:
                break
        return c, inertia
