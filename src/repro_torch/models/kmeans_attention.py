"""k-means-powered attention — the paper's technique as a model feature.

Port of ``repro/models/kmeans_attention.py`` (ROADMAP.md queue A item 7).
Two pieces:

1. ``build_clustered_cache`` — runs flash-kmeans over the cached keys of
   each (batch, kv_head) and reorganizes the KV cache into cluster buckets
   (the sort-inverse restructuring of the update kernel, applied to the KV
   cache). O(S·Kc·d) one-time cost.

2. ``clustered_decode_attention`` — a decode step scores the query against
   the Kc centroids, gathers only the top clusters' buckets plus a small
   always-attended recent buffer, and performs exact softmax attention
   within the selected set. Selection is per (batch, kv_head): the queries
   of a GQA group share it (their mean scores the centroids).

Where the reference ``vmap``s a single-head function over heads (and
``Engine`` again over the layer groups), every function here takes any
leading dims and runs all the problems together: ``cluster_keys`` is one
batched Lloyd fit (``core.kmeans._lloyd_loop``: FlashAssign and the
sort-inverse update, or FlashLloyd where the planner picks it, one launch a
kernel a step), and the refresh one batched warm-start ``partial_fit``
(``core.streaming.partial_fit_step_batched``). ``impl="ref"`` takes the
plain dataflows, as the reference's does.

Initial centroids: the reference draws them with ``jax.random.PRNGKey(seed)``
and hands the same key to every vmapped head, so every head starts from the
same row indices of its own keys. The port draws those indices once from a
``torch.Generator`` seeded with ``seed`` (other numbers than ``jax.random``'s)
and takes them in every problem; ``c0=`` hands in initial centroids
instead (the tests pass the JAX package's).

The JAX semantics kept where torch differs: ``jnp.argsort`` is stable
(``torch.sort(stable=True)``); ``lax.top_k`` takes the lower index on ties
(a stable descending sort, never ``torch.topk``); ``.at[...].set(mode=
"drop")`` drops rows whose slot is ``>= cap`` or whose id is the sentinel
``kc`` (masked before the write); ``jnp.bincount(length=kc)`` ignores ids
``>= kc``; a gather at the sentinel clamps to ``kc - 1``; the recent buffer's
``dynamic_update_slice`` clamps its start. The buckets and the recent buffer
are written in place (``append_to_buckets``, ``clustered_decode_attention``,
``refresh_clustered_cache``): a caller that keeps the old cache clones it.
Where the reference has ``stop_gradient`` the port detaches: no gradient
flows through the clustering, and ``kmeans_routed_attention`` is
differentiable in q, k and v (its bucket writes are ``index_put_`` into
fresh zero tensors, whose backward gathers the written rows).

Approximation note: the k-means itself is exact Lloyd; the sparse attention
built on it is approximate by design, and bucket overflow beyond
``capacity`` is dropped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import kmeans as _km
from repro_torch.core import streaming as _st
from repro_torch.core.kmeans import KMeansConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers.attention import NEG_INF, update_slice


def _problems(x: torch.Tensor, tail: int) -> tuple[tuple, torch.Tensor]:
    """(leading shape, x reshaped to (P, *last ``tail`` dims))."""
    lead = tuple(x.shape[:x.ndim - tail])
    return lead, x.reshape(math.prod(lead), *x.shape[x.ndim - tail:])


def _bincount(a: torch.Tensor, kc: int) -> torch.Tensor:
    """Per-row ``jnp.bincount(a, length=kc)`` of a (P, R) int tensor: ids
    ``>= kc`` are not counted. int32 (P, kc)."""
    out = torch.zeros((a.shape[0], kc + 1), dtype=torch.int32,
                      device=a.device)
    out.scatter_add_(1, a.long().clamp(0, kc),
                     torch.ones_like(a, dtype=torch.int32))
    return out[:, :kc]


def initial_centroids(x: torch.Tensor, kc: int, *, seed: int = 0
                      ) -> torch.Tensor:
    """x (P, S, hd): the same ``kc`` distinct rows of every problem, drawn
    from a ``torch.Generator`` seeded with ``seed`` (the reference's one
    PRNG key in every vmapped head)."""
    s = x.shape[1]
    if kc > s:
        raise ValueError(
            f"random_init needs at least k data points to draw k distinct "
            f"centroids, got k={kc} > n={s}")
    g = torch.Generator(device=x.device).manual_seed(seed)
    idx = torch.randperm(s, generator=g, device=x.device)[:kc]
    return x.index_select(1, idx)


def cluster_keys(keys: torch.Tensor, kc: int, *, iters: int = 5,
                 seed: int = 0, impl: str = "flash",
                 c0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """flash-kmeans over heads' keys. keys (..., S, hd) -> (centroids (...,
    kc, hd) in keys' dtype, assignments (..., S) int32): one batched fit of
    every leading problem.

    ``impl="ref"`` takes the plain assignment and scatter update. ``c0``
    (..., kc, hd) gives the initial centroids; else ``initial_centroids``
    draws them with ``seed``. The keys are detached: routing is discrete,
    no gradient flows through the clustering."""
    lead, x = _problems(keys.detach(), 2)
    x = x.float()
    if c0 is None:
        c0 = initial_centroids(x, kc, seed=seed)
    else:
        c0 = c0.reshape(x.shape[0], kc, x.shape[2]).to(x)
    cfg = KMeansConfig(k=kc, max_iters=iters, init="random",
                       assign_impl=impl,
                       update_impl="sort_inverse" if impl == "flash"
                       else "scatter")
    st = _km._lloyd_loop(x, c0, cfg)
    return (st.centroids.to(keys.dtype).reshape(*lead, kc, x.shape[2]),
            st.assignments.reshape(*lead, x.shape[1]))


def _bucketize(values: torch.Tensor, assign: torch.Tensor, kc: int,
               cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter (..., S, *f) rows into (..., kc, cap, *f) buckets by cluster
    id: ``append_to_buckets`` into empty buckets, overflow rows (slot >=
    cap) dropped. Returns (buckets, counts)."""
    lead = assign.shape[:-1]
    feat = values.shape[assign.ndim:]
    empty = torch.zeros((*lead, kc, cap, *feat), dtype=values.dtype,
                        device=values.device)
    return append_to_buckets(
        empty, torch.zeros((*lead, kc), dtype=torch.int32,
                           device=values.device), values, assign)


def append_to_buckets(buckets: torch.Tensor, bcount: torch.Tensor,
                      rows: torch.Tensor, assign: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Append new rows into existing cluster buckets, in place.

    buckets (..., kc, cap, *f), bcount (..., kc) current fill, rows (...,
    R, *f), assign (..., R) cluster ids. New rows land at ``slot =
    bcount[a] + rank`` (rank within their cluster, in stable sorted
    order); rows whose slot is ``>= cap`` or whose id is ``>= kc`` (the
    sentinel) are dropped. Returns (buckets, bcount'), ``buckets`` the
    tensor passed in, written in place; ``bcount`` is not modified."""
    kc = bcount.shape[-1]
    lead, a = _problems(assign, 1)
    p, r = a.shape
    cap = buckets.shape[len(lead) + 1]
    feat = buckets.shape[len(lead) + 2:]
    bk = buckets.view(p, kc, cap, *feat)
    bc = bcount.reshape(p, kc)
    rw = rows.reshape(p, r, *feat)
    a_sorted, order = torch.sort(a.long(), dim=-1, stable=True)
    counts = _bincount(a, kc)
    starts = torch.cumsum(counts, -1) - counts
    ai = a_sorted.clamp(max=kc - 1)           # JAX clamps the gather
    rank = torch.arange(r, device=a.device) - starts.gather(1, ai)
    slot = bc.gather(1, ai) + rank
    keep = (a_sorted < kc) & (slot < cap)     # mode="drop"
    pi = torch.arange(p, device=a.device).unsqueeze(1).expand(p, r)
    rows_sorted = rw[pi, order]
    bk[pi[keep], a_sorted[keep], slot[keep]] = \
        rows_sorted[keep].to(buckets.dtype)
    return buckets, torch.minimum(bcount + counts.reshape(bcount.shape),
                                  torch.tensor(cap, dtype=torch.int32,
                                               device=a.device)
                                  ).to(torch.int32)


def build_clustered_cache(k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                          kc: int, capacity: int, iters: int = 5,
                          c0: torch.Tensor | None = None) -> dict:
    """k/v (..., B, S, KH, hd) (keys already roped) -> the clustered cache
    dict, with leading shape (..., B, KH): ``centroids`` (kc, hd), ``bk``
    and ``bv`` (kc, capacity, hd), ``bcount`` (kc,) int32 (the bucket fill,
    capped), ``cweight`` (kc,) f32 (the uncapped point weight each centroid
    represents). All leading problems are clustered in one batched fit;
    ``c0`` (..., B, KH, kc, hd) as in ``cluster_keys``."""
    kt = k_cache.movedim(-2, -3)                     # (..., B, KH, S, hd)
    vt = v_cache.movedim(-2, -3)
    cents, assigns = cluster_keys(kt, kc, iters=iters, c0=c0)
    bk, counts = _bucketize(kt, assigns, kc, capacity)
    bv, _ = _bucketize(vt, assigns, kc, capacity)
    # cweight: the true per-cluster point weight the centroids represent
    # (uncapped: capacity-dropped rows still shaped the centroid). The
    # incremental refresh carries and decays it instead of bcount, which
    # saturates at capacity.
    lead, a = _problems(assigns, 1)
    weights = _bincount(a, kc).float().reshape(*lead, kc)
    return {"centroids": cents, "bk": bk, "bv": bv, "bcount": counts,
            "cweight": weights}


def refresh_clustered_cache(cache: dict, *, iters: int = 2,
                            decay: float = 1.0) -> dict:
    """Fold the recent buffer into the clustered cache incrementally.

    A warm-start decayed ``partial_fit`` over the buffer's keys, every
    (group, batch, kv_head) problem in one batched step
    (``core.streaming.partial_fit_step_batched``): the statistics are
    rebuilt losslessly from ``(centroids, cweight)``
    (``SufficientStats.from_centroids``), with no re-read of the bucketed
    keys and no refit. The refreshed centroids absorb the new tokens, the
    tokens are appended to their buckets in place (overflow dropped), and
    the recent buffer is reset. Only the first ``rlen`` buffer slots hold
    tokens; the tail enters neither the statistics nor the buckets.
    ``decay < 1`` down-weights the old statistics at each flush."""
    if not (0.0 < decay <= 1.0):
        raise ValueError(f"decay must be in (0, 1], got {decay}")
    cents = cache["centroids"]
    lead, c = _problems(cents, 2)
    p, kc, hd = c.shape
    rk, rv = cache["recent_k"], cache["recent_v"]
    r = rk.shape[-2]
    rlen = cache["rlen"]
    valid = torch.arange(r, device=rk.device) < rlen.reshape(
        *rlen.shape, *([1] * (len(lead) - rlen.ndim)), 1)
    valid = valid.expand(*lead, r).reshape(p, r)
    cfg = KMeansConfig(k=kc, max_iters=iters)
    c32 = c.float()
    stats = _st.SufficientStats.from_centroids(
        c32, cache["cweight"].reshape(p, kc))
    c_new, stats_new, a, _ = _st.partial_fit_step_batched(
        rk.reshape(p, r, hd).float(), c32, stats, cfg=cfg, decay=decay,
        local_iters=iters, mask=valid)
    a_eff = torch.where(valid, a, kc).reshape(*lead, r)  # sentinel: dropped
    bk, bc = append_to_buckets(cache["bk"], cache["bcount"], rk, a_eff)
    bv, _ = append_to_buckets(cache["bv"], cache["bcount"], rv, a_eff)
    return dict(cache,
                centroids=c_new.to(cents.dtype).reshape(cents.shape),
                bk=bk, bv=bv, bcount=bc,
                cweight=stats_new.counts.reshape(*lead, kc),
                recent_k=torch.zeros_like(rk), recent_v=torch.zeros_like(rv),
                rlen=torch.zeros_like(rlen))


def init_clustered_cache(batch: int, kv_heads: int, head_dim: int, *,
                         kc: int, capacity: int, recent: int,
                         dtype=torch.bfloat16, device=None) -> dict:
    """Zero cache with the clustered layout, on ``device`` (default
    ``"cuda"``)."""
    device = _km.resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "centroids": z(batch, kv_heads, kc, head_dim),
        "bk": z(batch, kv_heads, kc, capacity, head_dim),
        "bv": z(batch, kv_heads, kc, capacity, head_dim),
        "bcount": z(batch, kv_heads, kc, dt=torch.int32),
        "cweight": z(batch, kv_heads, kc, dt=torch.float32),
        "recent_k": z(batch, kv_heads, recent, head_dim),
        "recent_v": z(batch, kv_heads, recent, head_dim),
        "rlen": z(dt=torch.int32),
        "pos": z(dt=torch.int32),
    }


def _attention_stats(scores: torch.Tensor, v: torch.Tensor, eq: str):
    """Unnormalized attention pieces for two-pass logsumexp merging.

    scores: (..., q, T) masked with NEG_INF; v: (..., T, hd); ``eq`` is the
    weights@values einsum. Returns (acc (..., q, hd), m (..., q), l (...,
    q))."""
    m = scores.amax(-1)
    p = torch.exp(scores - m.unsqueeze(-1))
    return torch.einsum(eq, p, v), m, p.sum(-1)


def _merge_stats(a1, m1, l1, a2, m2, l2):
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    denom = l1 * w1 + l2 * w2
    return (a1 * w1.unsqueeze(-1) + a2 * w2.unsqueeze(-1)) \
        / torch.clamp(denom, min=1e-30).unsqueeze(-1)


def kmeans_routed_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, clusters: int,
                            window: int = 128, capacity_factor: float = 2.0,
                            kmeans_iters: int = 4, scale=None,
                            impl: str = "flash",
                            c0: torch.Tensor | None = None) -> torch.Tensor:
    """Cluster-routed causal self-attention (Routing-Transformer style, the
    paper's train-time online-kmeans workload), differentiable in q, k and
    v; the keys' clustering and the queries' assignment are detached.

    Keys are clustered per (batch, head), all heads in one batched fit;
    each query attends exactly to (a) its local window and (b) the
    same-cluster keys outside the window — a disjoint union merged with a
    two-pass logsumexp, so ``clusters=1`` reproduces full attention.
    Per-cluster buckets have a fixed capacity; overflow tokens keep window
    coverage only. The queries go to their clusters through FlashAssign
    (``impl="flash"``) or the plain assignment.

    q, k, v: (B, S, H, hd) (same #heads; GQA-expand before calling).
    ``c0`` (B, H, clusters, hd): the clustering's initial centroids.
    """
    b, s, h, hd = q.shape
    dev = q.device
    scale_ = scale if scale is not None else hd ** -0.5
    cap = max(8, int(s / clusters * capacity_factor))
    z = b * h

    qf = q.movedim(2, 1).reshape(z, s, hd)
    kf = k.movedim(2, 1).reshape(z, s, hd)
    vf = v.movedim(2, 1).reshape(z, s, hd)

    # ---- window pass (dense, banded) ------------------------------------
    pos = torch.arange(s, device=dev)
    win_mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))      # (S, S)
    scores_w = torch.einsum("zqd,zkd->zqk", qf, kf) * scale_
    scores_w = torch.where(win_mask, scores_w, NEG_INF)
    acc_w, m_w, l_w = _attention_stats(scores_w, vf, "zqk,zkd->zqd")
    del scores_w

    # ---- cluster pass, every (batch, head) at once ----------------------
    cents, ak = cluster_keys(kf, clusters, iters=kmeans_iters, impl=impl,
                             c0=c0)
    qsg = qf.detach().float()
    if impl == "flash":
        aq, _ = ops.flash_assign_batched(qsg, cents.float(),
                                         want_dists=False)
    else:
        aq, _ = ref.assign_ref(qsg, cents.float())
    zpos = pos.view(1, s, 1).expand(z, s, 1)
    bk, bcnt = _bucketize(kf, ak, clusters, cap)              # (Z,C,cap,hd)
    bv, _ = _bucketize(vf, ak, clusters, cap)
    bpos, _ = _bucketize(zpos, ak, clusters, cap)             # (Z,C,cap,1)
    bq, qcnt = _bucketize(qf, aq, clusters, cap)
    bqpos, _ = _bucketize(zpos, aq, clusters, cap)
    sc = torch.einsum("zcqd,zckd->zcqk", bq, bk) * scale_     # (Z,C,cap,cap)
    qp, kp = bqpos[..., 0], bpos[..., 0]
    slots = torch.arange(cap, device=dev)
    mask = kp[:, :, None, :] <= qp[:, :, :, None]             # causal
    mask &= kp[:, :, None, :] <= qp[:, :, :, None] - window   # disjoint
    mask &= slots[None, None, None, :] < bcnt[..., None, None]
    mask &= slots[None, None, :, None] < qcnt[..., None, None]
    sc = torch.where(mask, sc, NEG_INF)
    del mask
    acc_c, m_c, l_c = _attention_stats(sc, bv, "zcqk,zckd->zcqd")
    del sc
    # scatter back to the original query positions
    aq_sorted, order = torch.sort(aq.long(), dim=-1, stable=True)
    counts = _bincount(aq, clusters)
    starts = torch.cumsum(counts, -1) - counts
    rank = pos - starts.gather(1, aq_sorted)
    valid = rank < cap
    zi = torch.arange(z, device=dev).unsqueeze(1).expand(z, s)
    src = (zi, aq_sorted, torch.clamp(rank, max=cap - 1))
    acc_o = torch.zeros((z, s, hd), dtype=acc_c.dtype, device=dev)
    m_o = torch.full((z, s), NEG_INF, dtype=m_c.dtype, device=dev)
    l_o = torch.zeros((z, s), dtype=l_c.dtype, device=dev)
    acc_o[zi, order] = torch.where(valid.unsqueeze(-1), acc_c[src], 0.0)
    m_o[zi, order] = torch.where(valid, m_c[src], NEG_INF)
    l_o[zi, order] = torch.where(valid, l_c[src], 0.0)

    out = _merge_stats(acc_w, m_w, l_w, acc_o, m_o, l_o)      # (Z,S,hd)
    return out.reshape(b, h, s, hd).movedim(1, 2).to(q.dtype)


def clustered_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, cache: dict, *, top: int,
                               softcap: float | None = None,
                               scale: float | None = None
                               ) -> tuple[torch.Tensor, dict]:
    """One decode step against a clustered cache.

    q: (B, 1, H, hd) (already roped); k_new/v_new: (B, 1, KH, hd) — the
    current token's key/value, written into the recent buffer in place at
    ``rlen``. The ``top`` centroids of highest mean query score are taken,
    ties to the lower index. Returns (out (B, 1, H, hd), new_cache)."""
    b, _, h, hd = q.shape
    kh = k_new.shape[2]
    g = h // kh
    scale_ = scale if scale is not None else hd ** -0.5

    rlen = cache["rlen"]
    rk = update_slice(cache["recent_k"], k_new.movedim(1, 2), rlen, 2)
    rv = update_slice(cache["recent_v"], v_new.movedim(1, 2), rlen, 2)
    r = rk.shape[2]

    qg = q.reshape(b, kh, g, hd)                           # group per kv head

    # 1) score centroids: the mean over the query group, products in the
    # centroids' dtype accumulated in f32
    cents = cache["centroids"]                             # (B,KH,Kc,hd)
    cscores = torch.einsum("bkgd,bkcd->bkgc", qg.to(cents.dtype).float(),
                           cents.float())
    csel = cscores.mean(2)                                 # (B,KH,Kc)
    top_idx = torch.sort(csel, dim=-1, descending=True,
                         stable=True).indices[..., :top]   # (B,KH,top)

    # 2) gather only the selected buckets
    bi = torch.arange(b, device=q.device).view(b, 1, 1)
    ki = torch.arange(kh, device=q.device).view(1, kh, 1)
    gk = cache["bk"][bi, ki, top_idx]                      # (B,KH,top,cap,hd)
    gv = cache["bv"][bi, ki, top_idx]
    gcnt = cache["bcount"][bi, ki, top_idx]                # (B,KH,top)
    cap = gk.shape[3]
    gk = gk.reshape(b, kh, top * cap, hd)
    gv = gv.reshape(b, kh, top * cap, hd)

    # 3) exact attention over [selected buckets ++ recent buffer]
    keys = torch.cat([gk, rk], dim=2)                      # (B,KH,T,hd)
    vals = torch.cat([gv, rv], dim=2)
    scores = torch.einsum("bkgd,bktd->bkgt", qg.to(keys.dtype).float(),
                          keys.float()) * scale_
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    slot = torch.arange(cap, device=q.device)
    bucket_valid = slot[None, None, None] < gcnt.unsqueeze(-1)
    recent_valid = (torch.arange(r, device=q.device) <= rlen).expand(b, kh, r)
    valid = torch.cat([bucket_valid.reshape(b, kh, top * cap), recent_valid],
                      dim=2)
    scores = torch.where(valid.unsqueeze(2), scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(vals.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", w, vals)

    new_cache = dict(cache, recent_k=rk, recent_v=rv, rlen=rlen + 1,
                     pos=cache["pos"] + 1)
    return out.reshape(b, 1, h, hd), new_cache
