"""What one rank executes in a step: flops, HBM bytes and collectives,
counted op by op as the step runs.

Port of ``repro/launch/hlo_cost.py``. The reference walks the optimized
HLO of the per-device SPMD program; the port has no HLO, so ``OpCounter``
(a ``TorchDispatchMode``) counts the aten ops this rank runs, by
``hlo_cost``'s conventions:

  matmul family: flops as ``torch.utils.flop_counter.flop_registry``
                 gives them (mm, bmm, addmm, baddbmm, convolutions, SDPA:
                 2 * result * contracting, as ``dot``)
  reduction    : flops = input elements (sum, mean, amax, ...)
  softmax      : the reductions and elementwise ops of its decomposition
  elementwise  : flops = result elements (casts included)
  data movement: no flops (copies, concatenation, sorts, gathers, scatters)
  views and allocations: no cost at all
  bytes        : operands + results of each costed op, unfused, as eager
                 torch runs them; a gather charges the rows it reads (2 x
                 result + index), a scatter the rows it writes (3 x update +
                 index), as ``hlo_cost`` charges its windowed ops
  collectives  : counted under the reference's five names, with their
                 result bytes and group size (``roofline.wire_bytes``)

Run on a DTensor program, the mode sees each op twice: DTensor's sharding
propagation runs it once on global-shape fake tensors (to learn the
output's shape), then the rank runs it on its local tensors. Only the
second is this rank's work: an op with a ``FakeTensor`` operand or result
is not counted. A DTensor op itself is handed on (``NotImplemented``) and
counted through its local ops.

Collectives come from the ``_c10d_functional`` ops DTensor issues and
``_dtensor.shard_dim_alltoall``. On a ``"cpu"`` mesh DTensor replaces an
all-to-all by an all-gather and a chunk (``shard_dim_alltoall`` in
``torch/distributed/tensor/_collective_utils.py``: gloo has no
all-to-all); that stand-in is counted as the one all-to-all a CUDA mesh
issues, and its chunk copies are not counted.

A scan on meta tensors runs one step for the ``n`` in its middle
(``utils.loops.scan``); while the counter is entered it is the scan's
``on_repeat`` hook, and counts that step's ops ``n`` times, and the
backward of the autograd nodes the step made ``n`` times (those whose
sequence numbers lie between its carry's and its results'; the node
running an op in a backward is ``torch._C._current_autograd_node()``).

The counter also keeps the peak of the storage its ops allocate and that is
still alive (weak references to each new storage), the port's stand-in for
XLA's temp bytes, and a per-op table (``table``) from which ``analyze``
re-derives every total, so a saved table can be re-read without running
the step again.
"""
from __future__ import annotations

import gzip
import json
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline
from repro_torch.utils import loops
from repro_torch.utils import sharding as shd

_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "prod", "any", "all", "norm", "linalg_vector_norm", "logsumexp",
           "var", "var_mean", "std", "std_mean", "nansum", "count_nonzero",
           "aminmax"}
# (reductions of the input, elementwise ops of the result) of an op that
# XLA would decompose: softmax = max, subtract, exp, sum, divide
_COMPOSITE = {"_softmax": (2, 3), "_log_softmax": (2, 4),
              "_softmax_backward_data": (1, 3),
              "_log_softmax_backward_data": (1, 3)}
_MOVE = {"clone", "copy_", "copy", "cat", "stack", "sort", "topk", "flip",
         "roll", "constant_pad_nd", "repeat", "cumsum", "cummax", "cummin",
         "contiguous", "_to_copy", "unfold_backward", "slice_backward",
         "select_backward", "narrow_copy", "expand_copy", "masked_select",
         "nonzero"}
_GATHER = {"index_select", "gather", "embedding", "index", "_unsafe_index"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "index_copy",
            "index_copy_", "scatter", "scatter_", "scatter_add",
            "scatter_add_", "index_add", "index_add_", "scatter_reduce",
            "scatter_reduce_", "embedding_dense_backward"}
_ALLOC = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "zeros", "zeros_like", "new_zeros", "ones",
          "ones_like", "new_ones", "full", "full_like", "new_full",
          "scalar_tensor", "arange", "lift_fresh", "lift_fresh_copy",
          "zero_", "fill_", "_local_scalar_dense", "randn", "rand",
          "randint", "normal_", "uniform_", "bernoulli_", "resize_",
          "set_", "_wrap_tensor_autograd", "wait_tensor"}
# ops without an alias annotation that return their input's storage on a
# real device
_ALIASING = {"_wrap_tensor_autograd", "wait_tensor", "_unsafe_view",
             "lift_fresh", "alias", "detach"}
_COLLECTIVE = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all",
               "broadcast": "collective-permute"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _in_alltoall_standin(depth: int = 24) -> bool:
    """Whether the op runs inside DTensor's CPU all-to-all stand-in (an
    all-gather and a chunk in ``_collective_utils.shard_dim_alltoall``)."""
    f = sys._getframe(2)
    while f is not None and depth:
        code = f.f_code
        if code.co_name == "shard_dim_alltoall" and \
                code.co_filename.endswith("_collective_utils.py"):
            return True
        f, depth = f.f_back, depth - 1
    return False


_REPEAT_KEY = "repro_torch.repeat"   # a node's metadata: its backward's n


def _nodes_made(outputs, lo: int, hi: int) -> set:
    """The autograd nodes behind ``outputs`` whose sequence numbers lie in
    ``(lo, hi]``: those made between a node numbered ``lo`` and one
    numbered ``hi`` (a thread numbers its nodes in the order it makes
    them; a leaf's ``AccumulateGrad`` lies outside every such range)."""
    seen, todo = set(), [t.grad_fn for t in _tensors(outputs)]
    while todo:
        node = todo.pop()
        if node is None or node in seen or \
                not lo < node._sequence_nr() <= hi:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return seen


class OpCounter(TorchDispatchMode):
    """Counts what this rank executes while it is entered (see the module
    docstring). ``analyze()`` gives the totals; ``table`` the per-op
    counts; ``peak_bytes`` the peak of live storage allocated inside."""

    def __init__(self):
        super().__init__()
        # ops: name -> kind, count, flops, bytes; collectives: [kind,
        # group, result bytes, count] (filled by ``finish``)
        self.table = {"ops": {}, "collectives": []}
        self._coll: dict = {}
        self._groups: dict = {}
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._times = 1     # the product of the active repeated steps' n
        self._hook = None

    def __enter__(self):
        self._hook, loops.on_repeat = loops.on_repeat, self._repeated
        return super().__enter__()

    def __exit__(self, *exc):
        loops.on_repeat = self._hook
        return super().__exit__(*exc)

    def _repeated(self, n: int, run, carry):
        """``utils.loops.on_repeat``: ``run()``, a scan's step that stands
        for ``n`` given ``carry``, with its ops counted ``n`` times and the
        autograd nodes it made marked to count ``n`` times in the
        backward."""
        self._times *= n
        try:
            out = run()
        finally:
            self._times //= n
        lo = [t.grad_fn._sequence_nr() for t in _tensors(carry)
              if t.grad_fn is not None]
        hi = [t.grad_fn._sequence_nr() for t in _tensors(out)
              if t.grad_fn is not None]
        if lo and hi:
            for node in _nodes_made(out, max(lo), max(hi)):
                node.metadata[_REPEAT_KEY] = n
        return out

    # ---- the dispatch ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(shd.is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        if any(_is_fake(t) for t in ins) or any(_is_fake(t)
                                                for t in _tensors(out)):
            return out      # sharding propagation: not this rank's work
        self._count(func, args, kwargs, out)
        self._track(func, out)
        return out

    def _times_now(self) -> int:
        """How many times an op counts: inside a repeated scan step (in the
        forward, or its re-run by remat inside a backward) the step's ``n``,
        else the ``n`` the autograd node running it in a backward was
        marked with (``_repeated``)."""
        if self._times > 1:
            return self._times
        node = torch._C._current_autograd_node()
        return 1 if node is None else node.metadata.get(_REPEAT_KEY, 1)

    def _row(self, name: str, kind: str, flops: float, nbytes: float):
        times = self._times_now()
        row = self.table["ops"].setdefault(
            name, {"kind": kind, "count": 0, "flops": 0.0, "bytes": 0.0})
        row["count"] += times
        row["flops"] += times * float(flops)
        row["bytes"] += times * float(nbytes)

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        base = func.overloadpacket.__name__
        name = f"{ns}.{base}"
        if ns in ("_c10d_functional", "_dtensor") and base in _COLLECTIVE:
            self._collective(base, name, args, kwargs, out)
            return
        if base in _ALLOC or _is_view(func):
            return
        if _in_alltoall_standin():
            return          # the stand-in's chunk copies
        from torch.utils.flop_counter import flop_registry
        io = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self._row(name, "matmul", flops, io)
        elif base in _COMPOSITE:
            n_red, n_ew = _COMPOSITE[base]
            self._row(name, "elementwise",
                      n_red * _numel(args[0]) + n_ew * _numel(out), io)
        elif base in _REDUCE:
            self._row(name, "reduce", _numel(args[0]), io)
        elif base in _GATHER:
            idx = _nbytes(args[1:]) + _nbytes(kwargs)
            self._row(name, "gather", 0, 2 * _nbytes(out) + idx)
        elif base in _SCATTER:
            upd, idx = _scatter_operands(base, args)
            self._row(name, "scatter", 0, 3 * _nbytes(upd) + _nbytes(idx))
        elif base == "_to_copy" and _is_cast(args, out):
            self._row(name, "elementwise", _numel(out), io)
        elif base in _MOVE:
            self._row(name, "move", 0, io)
        else:
            self._row(name, "elementwise", _numel(out), io)

    def _collective(self, base: str, name: str, args, kwargs, out) -> None:
        kind = _COLLECTIVE[base]
        group = kwargs.get("group_name", args[-1])
        if base == "all_gather_into_tensor" and _in_alltoall_standin():
            kind, name = "all-to-all", "_dtensor.shard_dim_alltoall"
            size = _nbytes(args[0])     # an all-to-all's result: its input
            io = 2 * size
        else:
            size = _nbytes(out)
            io = _nbytes(args) + size
        key = group if isinstance(group, str) else id(group)
        if key not in self._groups:
            self._groups[key] = shd.group_size(group)
        p = self._groups[key]
        key = (kind, p, size)
        self._coll[key] = self._coll.get(key, 0) + self._times_now()
        self._row(name, "collective", 0, io)

    def _track(self, func, out) -> None:
        """Count the storage of every freshly allocated result until it
        dies (not the results of the ops that alias their input on a real
        device, whose meta kernels may allocate)."""
        if func.overloadpacket.__name__ in _ALIASING:
            return
        rets = func._schema.returns
        for i, t in enumerate(_tensors(out)):
            # a list return (``Tensor(a)[]``) is one entry for all its tensors
            if rets and rets[min(i, len(rets) - 1)].alias_info is not None:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._dead, key)

    def _dead(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ---- results ----
    def finish(self) -> dict:
        """The table with its collectives listed; call after the step."""
        self.table["collectives"] = sorted(
            [k, p, s, n] for (k, p, s), n in self._coll.items())
        return self.table

    def analyze(self) -> dict:
        return analyze(self.finish())


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and
                              not r.alias_info.is_write for r in rets)


def _is_cast(args, out) -> bool:
    src = args[0] if args and isinstance(args[0], torch.Tensor) else None
    return src is not None and isinstance(out, torch.Tensor) and \
        src.dtype != out.dtype


def _scatter_operands(base: str, args) -> tuple:
    """(the update, the index) of a scatter-family op's arguments."""
    if base.startswith("index_put") or base == "_index_put_impl_":
        return args[2], args[1]       # self, indices, values
    if base == "embedding_dense_backward":
        return args[0], args[1]       # grad, indices
    if base.startswith("index_"):
        return args[3], args[2]       # self, dim, index, source
    return args[3] if len(args) > 3 else args[0], args[2]  # scatter


def analyze(table: dict) -> dict:
    """The totals of a per-op table, under ``hlo_cost.analyze_text``'s
    keys, plus ``matmul_flops``."""
    ops = table["ops"].values()
    counts = {k: 0 for k in roofline.KINDS}
    wire = {k: 0.0 for k in roofline.KINDS}
    for kind, p, size, n in table["collectives"]:
        counts[kind] += n
        wire[kind] += n * roofline.wire_bytes(kind, size, p)
    return {"flops": sum(r["flops"] for r in ops),
            "hbm_bytes": sum(r["bytes"] for r in ops),
            "wire_bytes": sum(wire.values()),
            "collective_counts": counts,
            "collective_wire_bytes": wire,
            "matmul_flops": sum(r["flops"] for r in ops
                                if r["kind"] == "matmul")}


def save_table(table: dict, path: str) -> None:
    with gzip.open(path, "wt") as f:
        json.dump(table, f)


def load_table(path: str) -> dict:
    with gzip.open(path, "rt") as f:
        return json.load(f)
