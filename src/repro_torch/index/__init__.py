"""repro_torch.index — FlashIVF on the port's kernels (one device).

Public API:
  IVFIndex — coarse-quantized inverted-file index: ``build`` trains the
  coarse centroids with the port's ``KMeans``, ``search`` runs the
  FlashProbe kernels for the ``nprobe`` selection and the posting-list
  scan (int8 proposal + exact rescore on a ``q8`` store), ``add`` /
  ``refresh`` keep the index online through ``SufficientStats``.
  Runs on the card unless ``device="cpu"`` is asked for.

  PaddedBucketStore / QuantizedBucketStore / RescoreReservoir — the
  posting-list storage (``index/store.py``); DeviceRescoreCache — the q8
  rescore's rows in device memory (``index/rescore_cache.py``,
  ``rescore="device"``, the default); Fp32Codec / Int8ResidualCodec — the
  payload codecs (``index/quant.py``); FlatRouter / TwoLevelRouter — the
  cell selection (``index/router.py``, ``REPRO_ROUTER``).

  index_from_numpy / index_to_numpy / router_from_numpy — carry an index's
  state, its router's included, across packages (``index/bridge.py``);
  ``IVFIndex.save``/``load`` write and read snapshots in the reference's
  format (``repro_torch.reliability``), through ``restore_store``,
  ``infer_store_meta`` and ``restore_router``.

``IVFIndex(pctx=)`` / ``build(pctx=)`` shard the index over a
``core.parallel.ParallelContext`` mesh, on every search axis: both stores
(the paged pool over K-shards), both codecs (q8 with the rescore cache
sharded over cells) and both routers (the routed sharded probe), under
faults (a dead K-shard left out of every merge), with the guarded and
repairing refresh, and with snapshots that restore onto any mesh or none.
"""
from repro_torch.index.bridge import (index_from_numpy, index_to_numpy,
                                      router_from_numpy)
from repro_torch.index.ivf import IVFIndex, csr_from_assignments, recall_at_k
from repro_torch.index.quant import (CODEC_KINDS, Codec, Fp32Codec,
                                     Int8ResidualCodec, default_codec_kind,
                                     make_codec)
from repro_torch.index.rescore_cache import (RESCORE_KINDS,
                                             DeviceRescoreCache,
                                             default_rescore_kind)
from repro_torch.index.router import (ROUTER_KINDS, FlatRouter,
                                      TwoLevelRouter, default_router_kind,
                                      make_router, restore_router)
from repro_torch.index.store import (BucketStore, PaddedBucketStore,
                                     QuantizedBucketStore, RescoreReservoir,
                                     default_store_kind, infer_store_meta,
                                     make_quantized_store, make_store,
                                     restore_store)

__all__ = ["IVFIndex", "csr_from_assignments", "recall_at_k",
           "index_from_numpy", "index_to_numpy", "router_from_numpy",
           "BucketStore", "PaddedBucketStore", "QuantizedBucketStore",
           "RescoreReservoir", "default_store_kind", "make_store",
           "make_quantized_store", "restore_store", "infer_store_meta", "CODEC_KINDS", "Codec", "Fp32Codec",
           "Int8ResidualCodec", "default_codec_kind", "make_codec",
           "ROUTER_KINDS", "FlatRouter", "TwoLevelRouter",
           "default_router_kind", "make_router", "restore_router",
           "RESCORE_KINDS", "DeviceRescoreCache", "default_rescore_kind"]
