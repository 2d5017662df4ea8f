"""KernelPlanner — one cache-aware planning layer for every kernel dispatch.

Port of ``repro/core/plan.py`` for the k-means ops (``assign``, ``update``,
``step``), the FlashProbe ops (``probe``, ``scan``, ``scan_q8``,
``rescore``, and the port's ``scan_store`` and ``scan_q8_store``, the
posting-list scans that read the fp32 and the quantized store) and
``route``, the two-level router's geometry. The closed-form
math lives in ``core.heuristics``; this module owns the plan contract
(``plan(op, shape, dtype) -> KernelPlan``, with the shared-memory
footprint and modeled HBM bytes attached), the cache layers and hardware
detection (``detect_hardware`` maps a CUDA device onto a ``Hardware`` row
read from the card; ``device="cpu"`` gets the CPU row).

Cache layers, consulted in order: the in-process memo keyed on ``(op,
shape bucket, itemsize, hardware)`` — batch-like dims bucketed to the next
power of two — then an on-disk JSON file (``REPRO_PLAN_CACHE``: a path, or
``off``; by default ``~/.cache/flash_kmeans_torch/plans.json``), then the
choosers, each run counted in ``chooser_calls`` so tests can assert that a
repeated geometry is a pure cache hit. The file has the reference's format
(``CACHE_VERSION``); a plan on disk is used only on the hardware and the
build of ``csrc/`` (``kernels/_build.source_hash``) it was made for, and
every entry the port does not use — another card's, another build's, the
JAX package's — is written back verbatim. ``refine="measure"`` (or
``fold_measured``) folds ``core.autotune.exhaustive_tune``'s measured
tiles into the cache, from where they are served like any other plan.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.core import heuristics
from repro_torch.kernels import flash_probe as _fp
from repro_torch.kernels.ops import BlockConfig

# The file format, the reference's (``repro/core/plan.py``): a file of
# another version is ignored (not fatal) and overwritten. The port's entries
# carry ``package`` and the ``build`` of the kernels they were planned for.
CACHE_VERSION = 1
PACKAGE = "repro_torch"

OPS = ("assign", "update", "step", "probe", "scan", "scan_store", "scan_q8",
       "scan_q8_store", "route", "rescore")
_ARITY = {"assign": 3, "update": 3, "step": 3, "probe": 4, "scan": 4,
          "scan_store": 5, "scan_q8": 4, "scan_q8_store": 5, "route": 4,
          "rescore": 4}
# batch-like shape positions, bucketed to the next power of two; geometry
# dims (k, d, l, nprobe, width) stay exact
_BUCKET_DIMS = {"assign": (0,), "update": (0,), "step": (0,),
                "probe": (0,), "scan": (0, 1), "scan_store": (0,),
                "scan_q8": (0, 1), "scan_q8_store": (0,), "route": (0,),
                "rescore": (0, 1)}


def bucket_dim(v: int) -> int:
    """Next power of two >= v (floor 8)."""
    return max(8, 1 << max(0, int(v) - 1).bit_length())


def _itemsize(dtype) -> int:
    if isinstance(dtype, int):
        return dtype
    return dtype.itemsize


def _device(device) -> torch.device:
    """``None`` means the card: entry points run on CUDA unless asked."""
    return torch.device("cuda" if device is None else device)


def detect_hardware(device=None) -> heuristics.Hardware:
    """The ``Hardware`` row of a device.

    CPU -> ``heuristics.CPU``. CUDA -> the H100 data-sheet row (its peaks
    and memory rate), named after the card, with the SM count, L2 size and
    memory read from
    ``torch.cuda.get_device_properties`` and the block's opt-in shared
    memory from ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` (torch's
    ``shared_memory_per_block`` reports only the 48 KB default).
    """
    dev = _device(device)
    if dev.type == "cpu":
        return heuristics.CPU
    if dev.type != "cuda":
        raise ValueError(f"no hardware row for device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to plan for the CPU")
    from repro_torch.kernels import _build
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    return dataclasses.replace(
        heuristics.H100, name=props.name.lower().replace(" ", "_"),
        num_sms=props.multi_processor_count, l2_bytes=props.L2_cache_size,
        smem_block_bytes=_build.max_smem_optin(idx),
        hbm_bytes=props.total_memory)


def hardware_for(name: str | None, device=None) -> heuristics.Hardware:
    """The row a plan was made for (by ``plan.hw``), else the device's
    default planner's row."""
    planner = default_planner(device)
    if name is None or name == planner.hw.name:
        return planner.hw
    for hw in (heuristics.CPU, heuristics.H100):
        if hw.name == name:
            return hw
    return planner.hw


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The planner's answer for one (op, shape bucket, dtype, hardware).

    ``blocks`` are the op's own two tile dims; ``block`` the full
    ``BlockConfig``. ``smem_bytes`` is the shared-memory footprint at
    ``blocks`` (for ``step``: of the chosen path), ``smem_limit`` the
    block limit it was judged against, ``hbm_bytes`` the modeled traffic.
    ``cluster`` is the thread-block cluster size of a fused step's
    FlashLloyd or of the probe's tile mode (None otherwise).
    """
    op: str
    shape: tuple
    itemsize: int
    hw: str
    impl: str             # assign: "flash" | update: "sort_inverse"
                          # step: "fused" / "two_pass" | probe:
                          # "tile_topl" / "online_topl" | scan,
                          # rescore: "grouped_scan_warp" /
                          # "grouped_scan" |
                          # scan_store: "store_scan_cell" /
                          # "store_scan_list" |
                          # scan_q8: "grouped_scan_q8" |
                          # scan_q8_store: "store_scan_q8_cell" /
                          # "store_scan_q8_list" | route: "two_level" /
                          # "flat"
    blocks: tuple         # route: (K_c, nprobe_c), not tiles
    block: BlockConfig | None   # None for the probe ops
    smem_bytes: int
    smem_limit: int
    hbm_bytes: float
    cluster: int | None = None
    source: str = "heuristic"   # "heuristic" | "measured"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["blocks"] = list(self.blocks)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "KernelPlan":
        blk = d["block"]
        cluster = d["cluster"]
        return cls(
            op=str(d["op"]), shape=tuple(int(v) for v in d["shape"]),
            itemsize=int(d["itemsize"]), hw=str(d["hw"]),
            impl=str(d["impl"]), blocks=tuple(int(v) for v in d["blocks"]),
            block=None if blk is None else BlockConfig(
                **{k: int(v) for k, v in blk.items()}),
            smem_bytes=int(d["smem_bytes"]),
            smem_limit=int(d["smem_limit"]),
            hbm_bytes=float(d["hbm_bytes"]),
            cluster=None if cluster is None else int(cluster),
            source=str(d["source"]))


def _default_cache_path() -> str | None:
    """``REPRO_PLAN_CACHE`` (a path, or ``off``/``0``/``none``/empty for
    no file), else the port's own file under ``~/.cache``."""
    env = os.environ.get("REPRO_PLAN_CACHE")
    if env is not None:
        if env.strip().lower() in ("", "off", "0", "none"):
            return None
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "flash_kmeans_torch", "plans.json")


class KernelPlanner:
    """Single entry point for kernel dispatch planning.

    >>> planner = KernelPlanner(device="cpu")
    >>> p = planner.plan("step", (1_000_000, 1024, 128))
    >>> p.impl, p.blocks, p.smem_bytes

    ``cache_path`` names the plan file (``persist=False``: none; by default
    ``REPRO_PLAN_CACHE`` or the port's own file). ``device`` is where the
    hardware is read and where ``refine="measure"`` times its candidates
    (the CPU row's planner times on the CPU).
    """

    def __init__(self, hw: heuristics.Hardware | None = None, *,
                 device=None, cache_path: str | os.PathLike | None = None,
                 persist: bool = True):
        self.hw = hw if hw is not None else detect_hardware(device)
        self.device = torch.device("cpu") if self.hw.name == \
            heuristics.CPU.name else _device(device)
        self.cache_path = (str(cache_path) if cache_path is not None
                           else (_default_cache_path() if persist else None))
        self._mem: dict[str, KernelPlan] = {}
        # every raw entry on disk the port does not use (other hardware,
        # another build, the JAX package's), written back verbatim
        self._disk_raw: dict[str, dict] = {}
        self._disk_loaded = False
        self._build: str | None = None
        self.hits = 0
        self.misses = 0
        self.chooser_calls = 0   # closed-form planning passes actually run
        self.measure_calls = 0   # exhaustive tunes actually run
        self.disk_entries_loaded = 0

    def plan(self, op: str, shape, dtype=torch.float32, *,
             blk: BlockConfig | None = None,
             refine: str | None = None) -> KernelPlan:
        """Plan one dispatch. ``shape`` is ``(n, k, d)`` for the k-means
        ops, ``(n, k, d, l)`` for ``probe``, ``(b, c, d, l)`` for
        ``scan``/``scan_q8`` and ``(b, nprobe, width, d, l)`` for
        ``scan_store``, ``(b, k, d, nprobe)`` for ``route``; ``dtype`` a
        torch dtype or an itemsize.
        ``rescore`` (the q8 rescore fed by the device cache) takes the
        ``scan`` shape and kernel; only its modeled bytes add the cache
        gather (ref. ``repro/core/plan.py:408-421``).
        ``blk`` pins a ``BlockConfig`` (the plan is then judged, and
        memoized, for those tiles; the probe ops have none). ``refine`` in
        ``(None, "heuristic", "measure")``: ``"measure"`` runs (once per
        shape bucket) an exhaustive tune of the k-means ops and folds the
        measured tiles into the cache."""
        if op not in OPS:
            raise ValueError(f"unknown plan op {op!r}; expected one of {OPS}")
        shape = tuple(int(s) for s in shape)
        if len(shape) != _ARITY[op]:
            raise ValueError(f"op {op!r} expects a shape of arity "
                             f"{_ARITY[op]}, got {shape}")
        if refine not in (None, "heuristic", "measure"):
            raise ValueError(f"unknown refine backend {refine!r}")
        b = _itemsize(dtype)
        bshape = tuple(bucket_dim(s) if i in _BUCKET_DIMS[op] else s
                       for i, s in enumerate(shape))
        self._load_disk()
        measure = refine == "measure" and op in ("assign", "update", "step")
        if blk is not None:
            base = self._mem.get(self._key(op, bshape, b))
            if base is not None and base.block == blk:
                blk = None
        key = self._key(op, bshape, b, blk)
        got = self._mem.get(key)
        if got is not None:
            self.hits += 1
        else:
            self.misses += 1
            got = self._compute(op, bshape, b, blk)
            self._store(got, key, pinned=blk is not None)
        if measure and got.source != "measured":
            step = self.fold_measured(*bshape, b)
            return step if op == "step" else \
                self._mem[self._key(op, bshape, b)]
        return got

    def block_config(self, n: int, k: int, d: int,
                     dtype_bytes: int = 4) -> BlockConfig:
        """Full ``BlockConfig`` (all three kmeans legs) for a geometry."""
        return self.plan("step", (n, k, d), dtype_bytes).block

    def step_impl(self, n: int, k: int, d: int, dtype_bytes: int = 4,
                  blk: BlockConfig | None = None) -> str:
        """``"fused"`` or ``"two_pass"``, judged at ``blk`` when given."""
        return self.plan("step", (n, k, d), dtype_bytes, blk=blk).impl

    def fold_measured(self, n: int, k: int, d: int, dtype=torch.float32,
                      *, report=None) -> KernelPlan:
        """Fold an exhaustive tune into the cache for this shape bucket.

        ``report``: a ``core.autotune.TuneReport``; ``None`` runs the tune
        here on the planner's device (once, then cached, on disk too).
        The measured update tiles replace the heuristic's in the assign,
        update and step entries (the assign and fused tiles are the
        kernels' compiled ones); the fused leg and the crossover are
        judged again at the merged tiles. Returns the step plan.
        """
        b = _itemsize(dtype)
        bshape = (bucket_dim(n), int(k), int(d))
        if report is None:
            from repro_torch.core import autotune
            report = autotune.exhaustive_tune(
                *bshape, dtype={2: torch.bfloat16}.get(b, torch.float32),
                device=self.device)
            self.measure_calls += 1
        self._load_disk()
        base = self._compute("step", bshape, b, None)
        merged = dataclasses.replace(
            base.block,
            assign_block_n=report.best.assign_block_n,
            assign_block_k=report.best.assign_block_k,
            update_block_n=report.best.update_block_n,
            update_block_k=report.best.update_block_k)
        step = dataclasses.replace(self._compute("step", bshape, b, merged),
                                   source="measured")
        self._store(step, self._key("step", bshape, b), pinned=False)
        return step

    def counters(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "chooser_calls": self.chooser_calls,
                "measure_calls": self.measure_calls,
                "disk_entries_loaded": self.disk_entries_loaded,
                "entries": len(self._mem)}

    def clear(self, disk: bool = False) -> None:
        """Forget the memo (and, with ``disk``, delete the plan file)."""
        self._mem.clear()
        self._disk_raw.clear()
        self._disk_loaded = False
        if disk and self.cache_path:
            try:
                os.remove(self.cache_path)
            except FileNotFoundError:
                pass

    def _key(self, op: str, bshape: tuple, itemsize: int,
             blk: BlockConfig | None = None) -> str:
        blk_part = (None if blk is None else
                    [getattr(blk, f.name) for f in dataclasses.fields(blk)])
        return json.dumps([PACKAGE, op, list(bshape), itemsize, self.hw.name,
                           blk_part])

    def _leg_plans(self, s: tuple, b: int, cfg: BlockConfig,
                   source: str = "heuristic"):
        """The assign and update plans of one geometry and tile set."""
        H, hw = heuristics, self.hw
        n, k, d = s
        mk = lambda **kw: KernelPlan(shape=s, itemsize=b, hw=hw.name,
                                     block=cfg, source=source,
                                     smem_limit=hw.smem_block_bytes, **kw)
        assign = mk(op="assign", impl="flash",
                    blocks=(cfg.assign_block_n, cfg.assign_block_k),
                    smem_bytes=H.assign_footprint(
                        cfg.assign_block_n, cfg.assign_block_k, d, b,
                        dists=True),
                    hbm_bytes=H.assign_bytes_flash(n, k, d, b))
        update = mk(op="update", impl="sort_inverse",
                    blocks=(cfg.update_block_n, cfg.update_block_k),
                    smem_bytes=H.update_footprint(
                        cfg.update_block_n, cfg.update_block_k, d, b),
                    hbm_bytes=H.update_bytes_sort_inverse(
                        n, k, d, b, cfg.update_block_n))
        return assign, update

    def _compute(self, op: str, s: tuple, b: int,
                 blk: BlockConfig | None) -> KernelPlan:
        """Run the closed-form choosers for one cache miss."""
        H, hw = heuristics, self.hw
        self.chooser_calls += 1
        if op in ("probe", "scan", "scan_q8", "rescore"):
            return self._probe_plan(op, s, b)
        if op == "scan_store":
            return self._store_plan(s, b)
        if op == "scan_q8_store":
            return self._store_q8_plan(s)
        if op == "route":
            return self._route_plan(s, b)
        n, k, d = s
        cfg = blk if blk is not None else H.choose_blocks(
            n, k, d, dtype_bytes=b, hw=hw)
        assign, update = self._leg_plans(s, b, cfg)
        if op == "assign":
            return assign
        if op == "update":
            return update
        impl = H.choose_step_impl(n, k, d, dtype_bytes=b, hw=hw, blk=cfg)
        if impl == "fused":
            cl = H.choose_lloyd_cluster(k, d, b, hw)
            return dataclasses.replace(
                assign, op="step", impl=impl, cluster=cl,
                blocks=(cfg.fused_block_n, cfg.fused_block_k),
                smem_bytes=H.fused_footprint(k, d, b, cl),
                hbm_bytes=H.lloyd_bytes_fused(
                    n, k, d, b, H.fused_clusters(n, cl, hw)))
        return dataclasses.replace(
            assign, op="step", impl=impl,
            smem_bytes=max(assign.smem_bytes, update.smem_bytes),
            hbm_bytes=assign.hbm_bytes + update.hbm_bytes)

    def _probe_plan(self, op: str, s: tuple, b: int) -> KernelPlan:
        """A FlashProbe kernel, in the mode its wrapper takes for the shape
        (``flash_probe.probe_mode`` / ``grouped_mode``, the one rule both
        read). The probe's tile mode: ``cluster`` the CTAs of a
        thread-block cluster that split the centroids, ``blocks = (1,
        PROBE_TILE_QUERIES)``, no list-mode split and queries a CTA. The
        block scan's warp mode: ``blocks = (1, GROUPED_WARP_QUERIES)``, no
        split, queries a CTA, no dynamic shared memory. The list modes:
        ``blocks = (splits, PROBE_TILE)``, CTAs per query along the
        candidate axis and rows per selection round."""
        H, hw = heuristics, self.hw
        n, c, d, l = s
        if op == "probe":
            impl, hbm = "online_topl", H.probe_bytes(n, c, d, l, b)
        elif op == "scan":
            impl, hbm = "grouped_scan", H.scan_bytes(n, c, d, l, b)
        elif op == "rescore":
            impl, hbm = "grouped_scan", H.rescore_bytes(n, c, d, l)
        else:
            impl, hbm = "grouped_scan_q8", H.scan_q8_bytes(n, c, d, l)
        mk = lambda **kw: KernelPlan(op=op, shape=s, itemsize=b, hw=hw.name,
                                     block=None, smem_limit=hw.smem_block_bytes,
                                     hbm_bytes=hbm, **kw)
        if op == "probe" and _fp.probe_mode(l, d, b) == "tile":
            cl = H.choose_probe_cluster(n, c, l, hw)
            return mk(impl="tile_topl", cluster=cl,
                      blocks=(1, _fp.PROBE_TILE_QUERIES),
                      smem_bytes=_fp.probe_tile_smem(d, b, l, cl))
        if op in ("scan", "rescore") and \
                _fp.grouped_mode(l, c, d, b) == "warp":
            return mk(impl="grouped_scan_warp",
                      blocks=(1, _fp.GROUPED_WARP_QUERIES), smem_bytes=0)
        splits = H.choose_probe_splits(n, c, l, hw)
        lp = min(l, -(-c // splits))
        smem = max(H.probe_footprint(lp), H.probe_merge_footprint(l)
                   if splits > 1 else 0)
        return mk(impl=impl, blocks=(splits, H.PROBE_TILE), smem_bytes=smem)

    def _store_plan(self, s: tuple, b: int) -> KernelPlan:
        """The store scan: ``blocks = (splits, PROBE_TILE)``, the splits of
        ``flash_probe.store_geometry`` and the list mode's rows per
        selection round. ``hbm_bytes`` is the most it can read (every slot
        live, read once per pair)."""
        H, hw = heuristics, self.hw
        n, nprobe, width, d, l = s
        splits = H.choose_store_splits(n, nprobe, width, d, l, b, hw)
        _, _, lp, lists = _fp.store_geometry(nprobe, width, d, b, l, splits)
        merge = H.probe_merge_footprint(l) if lists > 1 else 0
        cell = _fp.store_cell_mode(l, d, b)
        smem = max(_fp.store_cell_smem(d, b) if cell
                   else H.probe_footprint(lp), merge)
        return KernelPlan(op="scan_store", shape=s, itemsize=b, hw=hw.name,
                          impl="store_scan_cell" if cell else "store_scan_list",
                          blocks=(splits, H.PROBE_TILE),
                          block=None, smem_bytes=smem,
                          smem_limit=hw.smem_block_bytes,
                          hbm_bytes=H.scan_store_bytes(n, nprobe, width, d,
                                                       l, b))

    def _store_q8_plan(self, s: tuple) -> KernelPlan:
        """The q8 store scan: ``blocks = (splits, PROBE_TILE)``, the splits
        of ``flash_probe.store_q8_geometry``; ``hbm_bytes`` the most it can
        read (every slot live, read once per pair)."""
        H, hw = heuristics, self.hw
        n, nprobe, width, d, l = s
        splits = H.choose_store_q8_splits(n, nprobe, width, d, l, hw)
        _, _, lp, lists = _fp.store_q8_geometry(nprobe, width, d, l, splits)
        merge = H.probe_merge_footprint(l) if lists > 1 else 0
        cell = _fp.store_q8_cell_mode(l, d)
        smem = max(_fp.store_q8_cell_smem(d) if cell
                   else H.probe_footprint(lp), merge)
        return KernelPlan(op="scan_q8_store", shape=s, itemsize=1,
                          hw=hw.name, impl="store_scan_q8_cell" if cell
                          else "store_scan_q8_list",
                          blocks=(splits, H.PROBE_TILE), block=None,
                          smem_bytes=smem, smem_limit=hw.smem_block_bytes,
                          hbm_bytes=H.scan_q8_store_bytes(n, nprobe, width,
                                                          d, l))

    def _route_plan(self, s: tuple, b: int) -> KernelPlan:
        """The two-level router's geometry for a K-cell index probed at
        depth ``nprobe`` (ref. ``repro/core/plan.py:377-394``): ``blocks =
        (K_c, nprobe_c)`` from ``choose_route_params``, ``impl``
        ``"two_level"`` where the routed probe's modeled bytes (at the
        modeled group capacity ``route_group_cap``) are below the flat
        probe's, else ``"flat"``. The coarse and fine stages take their
        own plans as ``probe`` and ``scan_store`` ops at the routed shapes;
        ``smem_bytes`` is the coarse probe's."""
        H, hw = heuristics, self.hw
        n, k, d, nprobe = s
        kc, npc = H.choose_route_params(k, nprobe)
        gcap = H.route_group_cap(k, kc)
        flat = H.probe_bytes(n, k, d, nprobe, b)
        routed = H.probe_bytes_routed(n, k, kc, npc, gcap, d, nprobe, b)
        coarse = self._probe_plan("probe", (n, kc, d, npc), b)
        return KernelPlan(op="route", shape=s, itemsize=b, hw=hw.name,
                          impl="two_level" if routed < flat else "flat",
                          blocks=(kc, npc), block=None,
                          smem_bytes=coarse.smem_bytes,
                          smem_limit=hw.smem_block_bytes,
                          hbm_bytes=min(routed, flat))

    def _store(self, plan: KernelPlan, key: str, pinned: bool) -> None:
        """Memoize ``plan``; an un-pinned step plan also fills its assign
        and update siblings (they share one ``choose_blocks`` run, so
        planning them again would be a phantom miss). Writes the file."""
        self._mem[key] = plan
        if plan.op == "step" and not pinned:
            for sib in self._leg_plans(plan.shape, plan.itemsize, plan.block,
                                       plan.source):
                self._mem[self._key(sib.op, sib.shape, sib.itemsize)] = sib
        self._save()

    def _build_hash(self) -> str:
        if self._build is None:
            from repro_torch.kernels import _build
            self._build = _build.source_hash()
        return self._build

    def _load_disk(self) -> None:
        """Read the plan file once: a missing, corrupt or other-version
        file plans from scratch; a bad entry of the port's is dropped; an
        entry of other hardware, another build or another package is kept
        for the next write and not used."""
        if self._disk_loaded or not self.cache_path:
            return
        self._disk_loaded = True
        try:
            with open(self.cache_path, encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION \
                or not isinstance(raw.get("plans"), dict):
            return
        for key, pd in raw["plans"].items():
            if not isinstance(pd, dict) or pd.get("package") != PACKAGE:
                self._disk_raw[key] = pd   # not the port's: kept verbatim
                continue
            try:
                plan = KernelPlan.from_dict(pd)
            except (KeyError, TypeError, ValueError, AttributeError):
                continue                   # a bad entry of the port's
            if plan.hw != self.hw.name or pd.get("build") != \
                    self._build_hash():
                self._disk_raw[key] = pd
            elif key not in self._mem:
                self._mem[key] = plan
                self.disk_entries_loaded += 1

    def _save(self) -> None:
        """Write every plan of the memo over the raw entries read (at most
        once a new geometry, never a dispatch), atomically; persistence is
        best effort."""
        if not self.cache_path:
            return
        self._load_disk()
        mine = {k: {**p.to_dict(), "package": PACKAGE,
                    "build": self._build_hash()}
                for k, p in self._mem.items()}
        payload = {"version": CACHE_VERSION,
                   "plans": {**self._disk_raw, **mine}}
        try:
            dirname = os.path.dirname(self.cache_path) or "."
            os.makedirs(dirname, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, self.cache_path)
        except OSError:
            pass   # a read-only file system: plans stay in memory


# ---------------------------------------------------------------------------
# per-device default planners
# ---------------------------------------------------------------------------

_DEFAULT: dict[str, KernelPlanner] = {}


def _planner_key(device) -> str:
    dev = _device(device)
    if dev.type != "cuda" or dev.index is not None:
        return str(dev)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return f"cuda:{torch.cuda.current_device()}"


def default_planner(device=None) -> KernelPlanner:
    """The process-wide planner of a device (``None`` -> ``"cuda"``)."""
    key = _planner_key(device)
    if key not in _DEFAULT:
        _DEFAULT[key] = KernelPlanner(device=key)
    return _DEFAULT[key]


def set_default_planner(planner: KernelPlanner | None, device=None) -> None:
    """Swap (or, with ``None``, drop) a device's default planner."""
    key = _planner_key(device)
    if planner is None:
        _DEFAULT.pop(key, None)
    else:
        _DEFAULT[key] = planner
