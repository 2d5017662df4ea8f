"""Guarded ingestion: query and insert validation with repair policies.

Port of ``repro/reliability/validate.py``. ``guard_batch`` is the one gate
both traffic classes go through:

- **shape / dtype** problems are caller bugs and always raise
  ``ValidationError``;
- **non-finite rows** follow the policy: ``reject`` raises, ``drop``
  removes the rows (inserts: never index garbage), ``sanitize`` zeroes the
  non-finite entries and keeps the row count (queries: result rows stay
  aligned with the request).

A numpy batch (or anything that is not a tensor) is validated on the host,
as in the reference. A tensor is validated where it lies: on the card that
is ``torch.isfinite`` there and one read of the bad-row count, with no copy
of the batch to the host. Both give the same ``clean`` rows and the same
``BatchReport``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class ValidationError(ValueError):
    """A batch failed ingestion validation (shape/dtype, or non-finite
    rows under the ``reject`` policy)."""


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """What the gate did to one batch."""

    n: int          # rows in (pre-policy)
    bad_rows: int   # rows containing at least one non-finite entry
    action: str     # "pass" | "sanitized" | "dropped"


POLICIES = ("reject", "drop", "sanitize")


def _guard_tensor(t: torch.Tensor, d: int, policy: str, name: str
                  ) -> tuple[torch.Tensor, BatchReport]:
    if t.ndim != 2 or t.shape[1] != d:
        raise ValidationError(
            f"{name}: expected a (B, {d}) array, got shape "
            f"{tuple(t.shape)}")
    if not t.dtype.is_floating_point:
        if t.dtype.is_complex or t.dtype == torch.bool:
            raise ValidationError(
                f"{name}: expected a float batch, got dtype "
                f"{str(t.dtype).rsplit('.', 1)[1]}")
        t = t.float()   # integers: lossless enough for ingestion
    finite = torch.isfinite(t)
    bad = ~finite.all(dim=1)
    nbad = int(bad.sum())   # the one read
    if nbad == 0:
        return t, BatchReport(t.shape[0], 0, "pass")
    if policy == "reject":
        raise ValidationError(
            f"{name}: {nbad} of {t.shape[0]} rows contain non-finite "
            f"values (first bad row {int(bad.nonzero()[0, 0])})")
    if policy == "drop":
        return t[~bad].contiguous(), BatchReport(t.shape[0], nbad, "dropped")
    return (torch.where(finite, t, torch.zeros((), dtype=t.dtype,
                                               device=t.device)),
            BatchReport(t.shape[0], nbad, "sanitized"))


def guard_batch(x, d: int, *, policy: str = "sanitize",
                name: str = "batch"):
    """Validate one ``(B, d)`` float batch; returns ``(clean, report)``.

    ``clean`` has no non-finite entries: a host float array (float32
    unless the input was already a wider or narrower float) for host
    input, a tensor on the input's device for a tensor. See the module
    docstring for the policies.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown validation policy {policy!r}; "
                         f"expected one of {POLICIES}")
    if isinstance(x, torch.Tensor):
        return _guard_tensor(x, d, policy, name)
    arr = np.asarray(x)
    if arr.ndim != 2 or arr.shape[1] != d:
        raise ValidationError(
            f"{name}: expected a (B, {d}) array, got shape {arr.shape}")
    if not np.issubdtype(arr.dtype, np.floating):
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32)   # lossless enough for ingestion
        else:
            raise ValidationError(
                f"{name}: expected a float batch, got dtype {arr.dtype}")
    finite = np.isfinite(arr)
    bad = ~finite.all(axis=1)
    nbad = int(bad.sum())
    if nbad == 0:
        return arr, BatchReport(arr.shape[0], 0, "pass")
    if policy == "reject":
        raise ValidationError(
            f"{name}: {nbad} of {arr.shape[0]} rows contain non-finite "
            f"values (first bad row {int(np.nonzero(bad)[0][0])})")
    if policy == "drop":
        return (np.ascontiguousarray(arr[~bad]),
                BatchReport(arr.shape[0], nbad, "dropped"))
    clean = arr.copy()
    clean[~finite] = 0.0
    return clean, BatchReport(arr.shape[0], nbad, "sanitized")
