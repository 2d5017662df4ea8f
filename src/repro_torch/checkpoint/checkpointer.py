"""Async, device-agnostic checkpoints of nested tensor state.

Port of ``repro/checkpoint/checkpointer.py``:

- one ``step_%08d.npz`` per step plus a JSON ``manifest.json`` (step,
  tree structure, keys, and each array's shape and dtype), both written
  atomically (tmp + rename);
- **async**: the device-to-host copy runs on the caller's thread, the npz
  and manifest writes on a background thread (``wait`` joins it);
- the tree is a nest of dicts, lists and tuples whose leaves are tensors
  or arrays (``None`` holds no leaf). Its keys are flattened in the string
  form of ``jax.tree_util.keystr`` (``"['a']['b']"``, ``"[0]"``, dict keys
  sorted), so a checkpoint written by either package restores in the
  other. ``restore(step, like, device=)`` puts the leaves on ``device``
  (``like``'s own device by default);
- **sharded state** (``pctx=``, a ``core.parallel.ParallelContext`` over
  the mesh): the DTensor leaves are gathered one at a time on every rank
  (a collective), rank 0 alone copies each to the host before the next
  is gathered, and writes, inside
  ``ParallelContext.rank0_write`` (every rank returns once the files are
  in place, or raises), so a save on a mesh is blocking. The files are the
  one-device format. ``restore(..., mesh=, shardings=)`` puts each leaf
  onto any mesh at the given placements (a ``like`` leaf that is a DTensor
  gives its own by default), every rank reading the file and keeping its
  slice.

``array_manifest`` and ``validate_arrays`` are the per-key shape/dtype
records the IVF snapshot manifest (``reliability/snapshot.py``) shares.
Dtypes are named as numpy names them (``float32``, ``int32``). A bfloat16
leaf is written as the reference writes one (``utils.host.host_array``: its
bits as the 2-byte void records, ``|V2``, that ``np.savez`` makes of an
``ml_dtypes`` bfloat16 array) under a manifest entry ``bfloat16``. Neither
package reads such a leaf back: ``restore`` raises ``TypeError`` on it, as
the reference's ``jax.device_put`` of a ``|V2`` array does.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.utils import sharding as shd
from repro_torch.utils.host import dtype_name, host_array, written_dtype


def _leaves(tree: Any, path: str = ""):
    """``(key, leaf)`` pairs in ``jax.tree_util`` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _flatten(tree: Any) -> dict:
    return dict(_leaves(tree))


def _treedef(tree: Any) -> str:
    """The tree's structure in ``str(jax.tree_util.tree_structure)`` form."""
    def s(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {s(t[k])}" for k in sorted(t)) \
                + "}"
        if isinstance(t, list):
            return "[" + ", ".join(s(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(s(v) for v in t) + \
                ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({s(tree)})"


def _unflatten(like: Any, leaves: dict, path: str = ""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, f"{path}[{i}]")
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return leaves[path]


def array_manifest(arrays: dict) -> dict:
    """Per-key ``{shape, dtype}`` records for a flat array dict, written
    into every manifest so a restore fails with a named mismatch."""
    return {k: {"shape": [int(s) for s in np.shape(v)],
                "dtype": written_dtype(v)}
            for k, v in arrays.items()}


def validate_arrays(expected: dict, arrays: dict, *, context: str) -> None:
    """Check a flat array dict against ``array_manifest`` records; raise
    one ``ValueError`` naming every missing key and every shape/dtype
    mismatch."""
    errs = []
    for key, spec in sorted(expected.items()):
        if key not in arrays:
            errs.append(f"missing key {key!r} "
                        f"(manifest says {spec['shape']} {spec['dtype']})")
            continue
        got = arrays[key]
        shape = [int(s) for s in np.shape(got)]
        dtype = dtype_name(got)
        if shape != list(spec["shape"]) or dtype != spec["dtype"]:
            errs.append(f"key {key!r}: manifest says {spec['shape']} "
                        f"{spec['dtype']}, found {shape} {dtype}")
    if errs:
        raise ValueError(f"{context}: manifest mismatch —\n  "
                         + "\n  ".join(errs))


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, pctx=None):
        self.dir = directory
        self.keep = keep
        self.pctx = pctx
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.last_save_seconds = 0.0

    # ---------------- save ----------------

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        t0 = time.perf_counter()
        flat = _flatten(state)
        if self.pctx is not None:
            # one leaf at a time: every rank gathers it (a collective), rank
            # 0 alone copies it to the host, and it is freed before the
            # next, so a device holds one whole leaf beside its shards
            host = {}
            for k, v in flat.items():
                whole = shd.gather(v)
                if self.pctx.is_world_rank0:
                    host[k] = host_array(whole)
                del whole
        else:
            # device -> host here; the disk writes on the background thread
            host = {k: host_array(v) for k, v in flat.items()}
        treedef = _treedef(state)

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}.npz")
            tmp = path + ".tmp.npz"
            np.savez(tmp, **host)
            os.replace(tmp, path)
            manifest = {"step": step, "treedef": treedef,
                        "keys": sorted(host.keys()),
                        "arrays": array_manifest(host)}
            mpath = os.path.join(self.dir, "manifest.json")
            with open(mpath + ".tmp", "w") as f:
                json.dump(manifest, f)
            os.replace(mpath + ".tmp", mpath)
            self._gc()

        self.wait()
        if self.pctx is not None:
            self.pctx.rank0_write(write)
            self.last_save_seconds = time.perf_counter() - t0
            return
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
        self.last_save_seconds = time.perf_counter() - t0

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _steps(self) -> list[str]:
        return sorted(f for f in os.listdir(self.dir)
                      if f.startswith("step_") and f.endswith(".npz")
                      and not f.endswith(".tmp.npz"))

    def _gc(self) -> None:
        for old in self._steps()[:-self.keep]:
            os.remove(os.path.join(self.dir, old))

    # ---------------- restore ----------------

    def latest_step(self) -> int | None:
        self.wait()
        ckpts = self._steps()
        if not ckpts:
            return None
        return int(ckpts[-1][len("step_"):-len(".npz")])

    def restore(self, step: int, like: Any, *, device=None, mesh=None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like``, each leaf a tensor on
        ``device`` (None: that ``like`` leaf's device, the CPU for an
        array). Validated before any leaf is built: every key ``like``
        asks for must exist, and where the manifest covers this step each
        leaf's shape and dtype must match its record. ``shardings`` (a tree
        of placement lists like ``like``'s, on ``mesh``) reshards onto any
        mesh; without it a DTensor leaf of ``like`` is restored at its own
        mesh and placements."""
        self.wait()
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        flat_like = _flatten(like)
        paths = list(flat_like.keys())
        with np.load(path) as data:
            missing = [k for k in paths if k not in data.files]
            if missing:
                raise ValueError(
                    f"restore(step {step}): checkpoint {path} is missing "
                    f"{len(missing)} requested keys (first: {missing[:3]}) — "
                    "tree structure changed since save?")
            mpath = os.path.join(self.dir, "manifest.json")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    manifest = json.load(f)
                if manifest.get("step") == step and "arrays" in manifest:
                    entries = manifest["arrays"]
                    validate_arrays(
                        {k: entries[k] for k in paths if k in entries},
                        flat_like, context=f"restore(step {step})")
            flat_sh = {} if shardings is None else _flatten_placements(
                shardings)
            leaves = {}
            for k in paths:
                ref = flat_like[k]
                dev = device if device is not None else (
                    ref.device if isinstance(ref, torch.Tensor) else "cpu")
                arr = data[k]
                if arr.dtype.kind == "V":   # a bfloat16 leaf's records
                    raise TypeError(f"restore(step {step}): key {k!r}: "
                                    f"dtype {arr.dtype} is not a valid "
                                    f"tensor dtype")
                t = torch.as_tensor(arr)
                if k in flat_sh or shd.is_dtensor(ref):
                    # this rank's slice, cut on the host
                    m, pl = ((mesh, flat_sh[k]) if k in flat_sh
                             else (ref.device_mesh, ref.placements))
                    leaves[k] = shd.global_of(
                        shd.local_slice(t, m, pl).contiguous().to(dev), m,
                        pl, t.shape)
                else:
                    leaves[k] = t.to(dev)
        return _unflatten(like, leaves)


def _flatten_placements(tree: Any) -> dict:
    """A tree of placement lists flattened with the checkpoint's keys (a
    placement list is a leaf)."""
    out: dict = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}[{k!r}]")
        elif isinstance(t, tuple):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        elif t is not None:
            out[path] = t
    walk(tree, "")
    return out
