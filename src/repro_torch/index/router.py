"""Query routing for FlashIVF — the Router layer.

Port of ``repro/index/router.py``. A flat search streams all K centroids
through FlashProbe for every query batch; the router decides which cells a
query probes:

- ``FlatRouter`` probes all K cells directly (the default);
- ``TwoLevelRouter`` trains a coarse k-means of ``K_c`` groups over the K
  fine centroids (the port's ``KMeans``: the centroids are a (K, d) point
  set). A query probes the coarse centroids first, then scans only the
  fine centroids of its ``nprobe_c`` nearest groups: ``K_c d + nprobe_c
  gcap d`` values a query instead of ``K d``, least at ``K_c ~
  sqrt(nprobe_c K)`` (``heuristics.choose_route_params``, the planner's
  ``route`` op).

Both routers answer the same calls: ``fingerprint(nprobe, nprobe_c)``,
the router's part of the search-geometry key (``()`` on the flat router);
``probe_plans``, the planner's plans of its kernels; ``view(centroids,
c_sq)``, what its search reads of an index's centroids; and ``cells(q,
view, ...)``, each query's ``nprobe`` cells. The index builds the view
from its own centroids and keeps it until its centroids move or the router
re-groups them (``version``), so a router shared by two indexes never
scores the other's centroids. A sharded index reads the two-level
router's ``candidates`` (the fine stage's cells, positions and scores)
and merges them across ranks itself.

The groups are the sorted-inverse grouping of the owner vector (one stable
argsort is the concatenation of all groups), padded into a ``(K_c, gcap)``
member table whose padding is the sentinel cell ``K``. The two-level
router's view is the fine centroids in member order, ``(K_c, gcap, d)``
with ``_PAD_COORD`` rows past each group's size: the fine stage reads that
table in place with the store scan (``ops.flash_probe_store``, counts the
group sizes) as a store of ``K_c`` pages of ``gcap`` rows, group g on
page g (the padded store's form), where the reference gathers a ``(B,
nprobe_c gcap, d)`` block of candidate centroids. The scan's probe-rank-major index ``p gcap +
w`` is the reference's candidate index, so ties resolve alike.

``refresh(centroids)`` re-assigns every fine centroid to its nearest group
after the index's ``refresh``, and every ``retrain_every`` refreshes runs
four warm-start Lloyd steps on the coarse centroids first. The tables are
rebuilt there, never on a search. ``nprobe = K`` covers every group, so the
routed search then equals the flat one. Training draws its initial coarse
centroids from a ``torch.Generator`` seeded with ``seed`` (the reference's
``jax.random.PRNGKey(seed)``), so the two packages train different coarse
levels from one seed; ``index/bridge.py`` carries a trained router across,
and ``restore_router`` rebuilds one from a snapshot's state.
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from repro_torch.core import heuristics
from repro_torch.core.kmeans import KMeans, KMeansConfig, resolve_device
from repro_torch.index.store import _PAD_COORD
from repro_torch.kernels import ops

ROUTER_KINDS = ("flat", "two_level")

# a two-level router's grouping version, unique across routers: an index
# keys its view of its centroids on it (the flat router's is 0)
_VERSIONS = itertools.count(1)


def default_router_kind() -> str:
    """The router ``REPRO_ROUTER`` selects ("flat" | "two_level", default
    "flat")."""
    kind = os.environ.get("REPRO_ROUTER", "flat").strip().lower()
    if kind not in ROUTER_KINDS:
        raise ValueError(f"REPRO_ROUTER={kind!r}: expected one of "
                         f"{ROUTER_KINDS}")
    return kind


def _pow2(v: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, int(v) - 1).bit_length())


def probe_cells(q, centroids, c_sq, *, nprobe: int, plan=None
                ) -> torch.Tensor:
    """FlashProbe over all K centroids picks each query's ``nprobe`` cells,
    (B, nprobe) int32."""
    probe, _ = ops.flash_probe(q, centroids.to(q.dtype), l=nprobe, plan=plan,
                               want_dists=False, c_sq=c_sq)
    return probe


class FlatRouter:
    """The single-level router: probe all K cells directly. It ignores
    ``nprobe_c``, as the reference's does."""

    kind = "flat"
    version = 0

    def fingerprint(self, nprobe: int, nprobe_c: int | None = None
                    ) -> tuple:
        return ()

    def probe_plans(self, planner, b: int, k: int, d: int, nprobe: int,
                    nprobe_c: int | None, dtype) -> tuple:
        return (planner.plan("probe", (b, k, d, nprobe), dtype),)

    def view(self, centroids, c_sq):
        """``(centroids, ||c||^2)``: what the probe reads."""
        return centroids, c_sq

    def cells(self, q, view, *, nprobe: int, nprobe_c: int | None = None,
              plans=(None,)) -> torch.Tensor:
        """(B, nprobe) int32 cells in ``[0, K)``."""
        centroids, c_sq = view
        return probe_cells(q, centroids, c_sq, nprobe=nprobe, plan=plans[0])

    def meta(self) -> dict:
        return {"kind": self.kind}

    def state_arrays(self) -> dict[str, np.ndarray]:
        return {}

    def refresh(self, centroids) -> None:   # nothing to keep consistent
        return None

    def __repr__(self) -> str:
        return "FlatRouter()"


class TwoLevelRouter:
    """Coarse-to-fine routing state.

    ``coarse`` (K_c, d) f32 and ``coarse_sq`` (K_c,) f32 on the router's
    device; ``owner`` (K,) int32 on the host, each fine cell's group;
    ``members`` (K_c, gcap) int32 on the device, group g's cells padded
    with the sentinel ``K``, and ``group_sizes`` (K_c,) int32. ``gcap`` is the largest group's size rounded up to a
    power of two (at least 8); it is part of the search geometry, so a
    re-grouping that crosses a bucket re-keys the search plans.
    ``device=None`` means ``"cuda"``.
    """

    kind = "two_level"

    def __init__(self, coarse, owner, *, nprobe_c: int | None = None, retrain_every: int = 8,
                 refreshes_since_train: int = 0, planner=None, device=None):
        self.device = resolve_device(device)
        self.coarse = torch.as_tensor(coarse).to(self.device,
                                                  torch.float32)
        self.owner = np.asarray(owner, np.int32)
        self.coarse_k = int(self.coarse.shape[0])
        self.k = int(self.owner.shape[0])
        self.nprobe_c = (heuristics.choose_coarse_nprobe()
                         if nprobe_c is None else max(1, int(nprobe_c)))
        self.nprobe_c = min(self.nprobe_c, self.coarse_k)
        self.retrain_every = max(1, int(retrain_every))
        self.refreshes_since_train = int(refreshes_since_train)
        self.planner = planner
        self._rebuild_members()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def train(cls, centroids, *, coarse_k: int | None = None,
              nprobe_c: int | None = None, recall_target: float = 0.95,
              max_iters: int = 8, retrain_every: int = 8, seed: int = 0,
              planner=None, device=None) -> "TwoLevelRouter":
        """Train the coarse level over the fine centroids with the port's
        ``KMeans`` (random init from a generator seeded with ``seed``).
        ``(K_c, nprobe_c)`` default to ``choose_route_params(K, K)``.
        ``device=None`` means ``"cuda"``, whatever device ``centroids``
        lie on."""
        dev = resolve_device(device)
        c = torch.as_tensor(centroids).to(dev)
        if c.dtype not in (torch.float32, torch.bfloat16):
            c = c.float()
        k = int(c.shape[0])
        auto_kc, auto_npc = heuristics.choose_route_params(
            k, k, recall_target=recall_target)
        kc = auto_kc if coarse_k is None else max(1, min(int(coarse_k), k))
        npc = auto_npc if nprobe_c is None else nprobe_c
        cfg = KMeansConfig(k=kc, max_iters=max_iters, planner=planner)
        gen = torch.Generator(device=dev).manual_seed(seed)
        coarse = KMeans(cfg, device=dev).fit(c, generator=gen).centroids
        owner, _ = ops.flash_assign(c, coarse.to(c.dtype), want_dists=False)
        return cls(coarse, owner.cpu().numpy(), nprobe_c=npc,
                   retrain_every=retrain_every, planner=planner, device=dev)

    def _rebuild_members(self) -> None:
        """The member table and ``group_sizes`` from ``owner`` (the
        sorted-inverse grouping, on the host at refresh time), under a new
        ``version``."""
        owner = self.owner
        order = np.argsort(owner, kind="stable").astype(np.int32)
        sizes = np.bincount(owner, minlength=self.coarse_k)
        self.gcap = _pow2(int(sizes.max()) if sizes.size else 1)
        members = np.full((self.coarse_k, self.gcap), self.k, np.int32)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        col = np.arange(owner.size, dtype=np.int64) - np.repeat(starts,
                                                                sizes)
        members[owner[order], col] = order
        self.members = torch.as_tensor(members, device=self.device)
        self.group_sizes = torch.as_tensor(sizes.astype(np.int32),
                                           device=self.device)
        self.coarse_sq = (self.coarse * self.coarse).sum(-1)
        self.version = next(_VERSIONS)

    # ------------------------------------------------------------------
    # consistency under online mutation
    # ------------------------------------------------------------------

    def refresh(self, centroids) -> None:
        """Keep the coarse level consistent after the fine centroids moved
        (the index's ``refresh``): every ``retrain_every`` refreshes, four
        warm-start Lloyd steps on the coarse centroids (never a cold
        refit); then every fine centroid goes to its nearest group and the
        member table is rebuilt."""
        c = torch.as_tensor(centroids).to(self.device)
        self.refreshes_since_train += 1
        if self.refreshes_since_train >= self.retrain_every:
            km = KMeans(KMeansConfig(k=self.coarse_k, planner=self.planner),
                        device=self.device)
            coarse = self.coarse.to(c.dtype)
            for _ in range(4):
                coarse, _, _ = km.iterate(c, coarse)
            self.coarse = coarse.float()
            self.refreshes_since_train = 0
        owner, _ = ops.flash_assign(c, self.coarse.to(c.dtype),
                                    want_dists=False)
        self.owner = owner.cpu().numpy().astype(np.int32)
        self._rebuild_members()

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def probe_plans(self, planner, b: int, k: int, d: int, nprobe: int,
                    nprobe_c: int | None, dtype) -> tuple:
        """The coarse ``probe`` at ``(b, K_c, d, nprobe_c)`` and the fine
        ``scan_store`` at ``(b, nprobe_c, gcap, d, leff)`` (ref.
        l.1093-1103)."""
        _, npc, gcap = self.fingerprint(nprobe, nprobe_c)
        return (planner.plan("probe", (b, self.coarse_k, d, npc), dtype),
                planner.plan("scan_store",
                             (b, npc, gcap, d, min(nprobe, npc * gcap)),
                             dtype))

    def view(self, centroids, c_sq=None) -> torch.Tensor:
        """The fine stage's table over these fine centroids: ``(K_c, gcap,
        d)``, group g's centroids in member order and ``_PAD_COORD`` rows
        past its size."""
        c = torch.as_tensor(centroids).to(self.device)
        cpad = torch.cat([c, torch.full((1, c.shape[1]), _PAD_COORD,
                                        dtype=c.dtype, device=self.device)])
        return cpad[self.members.long()]

    def candidates(self, q, view, *, nprobe: int, nprobe_c: int | None = None,
                   plans=(None, None)
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The fine stage: FlashProbe over the ``K_c`` coarse centroids picks
        each query's ``nprobe_c`` groups; the store scan over ``view``
        (``view()``'s table), read in place, keeps the ``leff = min(nprobe,
        nprobe_c gcap)`` nearest of those groups' fine centroids. Returns
        ``(member, li, v)``, each ``(B, leff)``, ascending by ``v``: the
        candidates' cells (int32; the sentinel ``K`` past a group's size),
        their candidate-axis positions ``p gcap + w`` (int64) and scores
        ``||c||^2 - 2 q.c``."""
        _, npc, gcap = self.fingerprint(nprobe, nprobe_c)
        leff = min(nprobe, npc * gcap)
        cidx, _ = ops.flash_probe(q, self.coarse.to(q.dtype), l=npc,
                                  plan=plans[0], want_dists=False,
                                  c_sq=self.coarse_sq)
        li, v = ops.flash_probe_store(q, view.to(q.dtype), self.group_sizes,
                                      cidx, width=gcap, l=leff,
                                      pad=_PAD_COORD, plan=plans[1],
                                      want_dists=False)
        li = li.long()
        group = torch.gather(cidx.long(), 1,
                             torch.div(li, gcap, rounding_mode="floor"))
        return self.members[group, li % gcap], li, v

    def cells(self, q, view, *, nprobe: int, nprobe_c: int | None = None,
              plans=(None, None)) -> torch.Tensor:
        """Two-level cell selection (ref. ``_route_cells``, l.177-211): the
        ``candidates``. Returns ``(B, nprobe)`` int32 cells in ``[0, K]``,
        ascending by distance: entries that are no fine centroid (past a
        group's size, or not finite) are the sentinel ``K``, and so is the
        tail past ``leff``."""
        member, _, v = self.candidates(q, view, nprobe=nprobe,
                                       nprobe_c=nprobe_c, plans=plans)
        cells = torch.where(torch.isfinite(v), member, self.k)
        if cells.shape[1] < nprobe:
            cells = torch.nn.functional.pad(
                cells, (0, nprobe - cells.shape[1]), value=self.k)
        return cells

    # ------------------------------------------------------------------
    # geometry + serialization
    # ------------------------------------------------------------------

    def effective_nprobe_c(self, nprobe: int, nprobe_c: int | None = None
                           ) -> int:
        """Coarse width for a probe depth: an explicit ``nprobe_c`` wins;
        otherwise the trained width, raised in proportion to ``nprobe`` so
        that ``nprobe = K`` covers every group (the routed search then
        equals the flat one)."""
        if nprobe_c is not None:
            return max(1, min(int(nprobe_c), self.coarse_k))
        scaled = -(-self.coarse_k * int(nprobe) // max(1, self.k))
        return min(self.coarse_k, max(self.nprobe_c, scaled))

    def fingerprint(self, nprobe: int, nprobe_c: int | None = None
                    ) -> tuple:
        """The router's part of the search-geometry key: ``(K_c,
        nprobe_c_eff, gcap)``."""
        return (self.coarse_k, self.effective_nprobe_c(nprobe, nprobe_c),
                self.gcap)

    def meta(self) -> dict:
        return {"kind": self.kind, "coarse_k": self.coarse_k,
                "nprobe_c": self.nprobe_c,
                "retrain_every": self.retrain_every,
                "refreshes_since_train": self.refreshes_since_train}

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The coarse centroids and the owner vector (the tables rebuild
        from them)."""
        return {"router_coarse": self.coarse.cpu().numpy(),
                "router_owner": self.owner.copy()}

    def __repr__(self) -> str:
        return (f"TwoLevelRouter(K_c={self.coarse_k}, K={self.k}, "
                f"nprobe_c={self.nprobe_c}, gcap={self.gcap})")


def make_router(spec, centroids=None, *, planner=None, device=None,
                **train_kw):
    """Resolve ``IVFIndex``'s ``router=``: a router passes through,
    ``None`` reads ``REPRO_ROUTER``, else a kind string. The two-level
    router trains here over ``centroids``."""
    if isinstance(spec, (FlatRouter, TwoLevelRouter)):
        return spec
    kind = default_router_kind() if spec is None else str(spec)
    if kind == "flat":
        return FlatRouter()
    if kind == "two_level":
        return TwoLevelRouter.train(centroids, planner=planner,
                                    device=device, **train_kw)
    raise ValueError(f"unknown router kind {kind!r}; expected one of "
                     f"{ROUTER_KINDS}")


def restore_router(meta: dict | None, host: dict, *, planner=None,
                   device=None):
    """A router from snapshot state (ref. l.257-268): ``meta`` is the
    manifest's ``router`` entry (absent in v1-v3 snapshots: the flat
    router), ``host`` holds ``router_coarse`` and ``router_owner``. The
    router is rebuilt from its state, never re-trained. ``device=None``
    means ``"cuda"``."""
    if not meta or meta.get("kind", "flat") == "flat":
        return FlatRouter()
    return TwoLevelRouter(
        np.array(host["router_coarse"], np.float32),   # writable copies
        np.array(host["router_owner"], np.int32),
        nprobe_c=int(meta["nprobe_c"]),
        retrain_every=int(meta.get("retrain_every", 8)),
        refreshes_since_train=int(meta.get("refreshes_since_train", 0)),
        planner=planner, device=device)
