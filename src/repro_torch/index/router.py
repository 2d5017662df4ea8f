"""Query routing for FlashIVF — the Router layer.

Port of ``repro/index/router.py`` for the single-level router:
``FlatRouter`` probes all K cells with one FlashProbe. The two-level
router (a coarse k-means over the K centroids) is not ported yet:
``make_router("two_level")`` raises ``NotImplementedError``.
"""
from __future__ import annotations

ROUTER_KINDS = ("flat", "two_level")


class FlatRouter:
    """The single-level router: probe all K cells directly."""

    kind = "flat"

    def __repr__(self) -> str:
        return "FlatRouter()"


def make_router(spec=None) -> FlatRouter:
    """Resolve ``IVFIndex``'s ``router=``: a ``FlatRouter`` passes
    through, ``None`` means ``"flat"``, else a kind string."""
    if isinstance(spec, FlatRouter):
        return spec
    kind = "flat" if spec is None else str(spec)
    if kind == "flat":
        return FlatRouter()
    if kind == "two_level":
        raise NotImplementedError(
            "router 'two_level' is not ported yet (ROADMAP.md, queue A "
            "item 4)")
    raise ValueError(f"unknown router kind {kind!r}; expected one of "
                     f"{ROUTER_KINDS}")
