"""Async, device-agnostic checkpoints of nested tensor state.

Port of ``repro/checkpoint/checkpointer.py`` for one device:

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
  (``like``'s own device by default).

``array_manifest`` and ``validate_arrays`` are the per-key shape/dtype
records the IVF snapshot manifest (``reliability/snapshot.py``) shares.
Dtypes are named as numpy names them (``float32``, ``int32``); a bfloat16
leaf is refused, since its numpy form needs ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch


def _dtype_name(v) -> str:
    """A leaf's dtype as numpy names it (``torch.float32`` -> ``float32``)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).rsplit(".", 1)[1]
    return str(v.dtype if hasattr(v, "dtype") else np.asarray(v).dtype)


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


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise NotImplementedError(
                "a bfloat16 leaf has no numpy form without ml_dtypes; cast "
                "it to float32 before saving")
        return v.detach().cpu().numpy()
    return np.asarray(v)


def array_manifest(arrays: dict) -> dict:
    """Per-key ``{shape, dtype}`` records for a flat array dict, written
    into every manifest so a restore fails with a named mismatch."""
    return {k: {"shape": [int(s) for s in np.shape(v)],
                "dtype": _dtype_name(v)}
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
        dtype = _dtype_name(got)
        if shape != list(spec["shape"]) or dtype != spec["dtype"]:
            errs.append(f"key {key!r}: manifest says {spec['shape']} "
                        f"{spec['dtype']}, found {shape} {dtype}")
    if errs:
        raise ValueError(f"{context}: manifest mismatch —\n  "
                         + "\n  ".join(errs))


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.last_save_seconds = 0.0

    # ---------------- save ----------------

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        t0 = time.perf_counter()
        # device -> host here; the disk writes on the background thread
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
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

    def restore(self, step: int, like: Any, *, device=None) -> Any:
        """Restore into the structure of ``like``, each leaf a tensor on
        ``device`` (None: that ``like`` leaf's device, the CPU for an
        array). Validated before any leaf is built: every key ``like``
        asks for must exist, and where the manifest covers this step each
        leaf's shape and dtype must match its record."""
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
            leaves = {}
            for k in paths:
                ref = flat_like[k]
                dev = device if device is not None else (
                    ref.device if isinstance(ref, torch.Tensor) else "cpu")
                leaves[k] = torch.as_tensor(data[k]).to(dev)
        return _unflatten(like, leaves)
