"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``. The build goes
to ``build/repro_torch/<hash>/`` at the repository root, keyed on a hash of
the sources and flags, and happens at first use: importing this module
builds nothing and needs no ``nvcc``. Processes that build at once (the
ranks of a mesh) take turns on an ``flock`` of ``<hash>/.lock``: the first
compiles, into object files named by its process id, and links; the others
then find the finished library and load it.

Every C entry point returns a ``cudaError_t``; ``check`` raises on a
non-zero code. Pointers and the stream are passed as ``ctypes.c_void_p``.
A kernel that cannot be built, loaded or launched raises
``KernelUnavailable``, which the serving ladder never absorbs.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argument types; every function returns int (cudaError_t)
SIGNATURES = {
    # x, c, csq, c split, a, m, B, N, K, d, is_bf16, want_dists, stream
    "fk_flash_assign": (_P,) * 6 + (_I,) * 6 + (_P,),
    "fk_flash_assign_smem": (_I, _I, _I, ctypes.POINTER(_I)),
    # x, sorted_idx, ids_sorted, out, R, d, S, chunk, threads, is_bf16, stream
    "fk_sort_inverse_update": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "fk_sort_inverse_layout": (_I, _I, _I, _I, _I, ctypes.POINTER(_I)),
    # x, c, csq, c split, a, sums, counts, inertia partials, B, N, K, dp,
    # cluster, grid_x, is_bf16, stream
    "fk_flash_lloyd": (_P,) * 9 + (_I,) * 7 + (_P,),
    # is_bf16, dp, K, cluster, dynamic bytes out, static bytes out
    "fk_flash_lloyd_smem": (_I,) * 4 + (ctypes.POINTER(_I),) * 2,
    # is_bf16, dp, K, cluster, resident clusters out
    "fk_flash_lloyd_clusters": (_I,) * 4 + (ctypes.POINTER(_I),),
    "fk_max_smem_optin": (_I, ctypes.POINTER(_I)),
    "fk_empty_launch": (_P,),
    # q, c, csq, 8 output/partial/scratch pointers, N, K, d, L, S, chunk,
    # lp, is_bf16, stream
    "fk_flash_probe": (_P,) * 11 + (_I,) * 8 + (_P,),
    # q, c, csq, out_v, out_i, N, K, d, L, cluster, chunk, is_bf16, stream
    "fk_flash_probe_tile": (_P,) * 5 + (_I,) * 7 + (_P,),
    # row bytes, L, cluster, bytes out
    "fk_flash_probe_tile_smem": (_I, _I, _I, ctypes.POINTER(_I)),
    # q, c, 8 output/partial/scratch pointers, B, C, d, L, S, chunk, lp,
    # is_bf16, stream
    "fk_flash_probe_grouped": (_P,) * 10 + (_I,) * 8 + (_P,),
    # q, c, out_v, out_i, B, C, d, L, is_bf16, stream
    "fk_flash_probe_grouped_warp": (_P,) * 4 + (_I,) * 5 + (_P,),
    # qp, codes, scales, qsq, 8 output/partial/scratch pointers, B, P, W,
    # d, L, S, chunk, lp, stream
    "fk_flash_probe_grouped_q8": (_P,) * 12 + (_I,) * 8 + (_P,),
    # q, rows, table, counts, probe, sorted cells, order, units, 8
    # output/partial/scratch pointers, B, P, maxp, page_size, width, d, L,
    # S, chunk, lp, tile_rows, pad, cell mode, is_bf16, stream
    "fk_flash_probe_store": (_P,) * 16 + (_I,) * 11 + (ctypes.c_float, _I, _I,
                                                       _P),
    # qp, qsq, codes, scales, table, counts, probe, sorted cells, order,
    # units, 8 output/partial/scratch pointers, B, P, maxp, page_size,
    # width, d, L, S, chunk, lp, tile_rows, cell mode, stream
    "fk_flash_probe_store_q8": (_P,) * 18 + (_I,) * 12 + (_P,),
    "fk_flash_probe_attrs": (_I, ctypes.POINTER(_I), ctypes.POINTER(_I)),
    # keys, rows, ref, hand, ids, x, order, seg, sets, ways, d, vec, stream
    "fk_rescore_cache_insert": (_P,) * 8 + (_I,) * 4 + (_P,),
}

class KernelUnavailable(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched. The
    serving engine's degradation ladder re-raises it: a search or an add
    is never answered by the plain version in the kernel's place."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
ptxas_log: str = ""


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelUnavailable(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the repro_torch CUDA kernels are built from "
        "src/repro_torch/csrc at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link ``libfkmeans.so``;
    returns its path. A build already present for this hash is reused, with
    the ``-Xptxas -v`` log it left beside it (``ptxas_log``). The check,
    the compiles and the link run under an exclusive ``flock`` of the hash
    directory's lock file, so processes that build at once do it once."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libfkmeans.so"
    if lib.is_file():
        return _reuse(out_dir)
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if lib.is_file():                  # another process built it
            return _reuse(out_dir)
        return _compile_and_link(nvcc, out_dir)


def _reuse(out_dir: Path) -> Path:
    global ptxas_log
    log = out_dir / "ptxas.log"
    if not ptxas_log and log.is_file():
        ptxas_log = log.read_text()
    return out_dir / "libfkmeans.so"


def _compile_and_link(nvcc: str, out_dir: Path) -> Path:
    global build_seconds, ptxas_log
    import time
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise KernelUnavailable(f"nvcc failed for {failed}:\n"
                                + "\n".join(logs))
    tmp = out_dir / f"libfkmeans.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelUnavailable(f"nvcc link failed:\n{link.stdout}")
    ptxas_log = "\n".join(logs)
    (out_dir / "ptxas.log").write_text(ptxas_log)
    lib = out_dir / "libfkmeans.so"
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError as e:
                raise KernelUnavailable(f"cannot load the kernel library: "
                                        f"{e}") from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelUnavailable(f"{what} failed: CUDA error {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def max_smem_optin(device_index: int = 0) -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of a device (232,448
    bytes on sm_90); ``torch``'s ``shared_memory_per_block`` reports only
    the 48 KB default."""
    out = ctypes.c_int(0)
    check(lib().fk_max_smem_optin(device_index, ctypes.byref(out)),
          "cudaDeviceGetAttribute")
    return int(out.value)


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel on the device's current stream (the floor of
    any launch's device time)."""
    check(lib().fk_empty_launch(stream_ptr(device)), "empty kernel launch")


def assign_dynamic_smem(is_bf16: bool, d: int, want_dists: bool = False
                        ) -> int:
    """The dynamic shared memory FlashAssign's launch at width ``d`` (with
    or without distances) sets, read back from the kernel's attributes."""
    out = ctypes.c_int(0)
    check(lib().fk_flash_assign_smem(int(is_bf16), d, int(want_dists),
                                     ctypes.byref(out)),
          "cudaFuncGetAttributes")
    return int(out.value)


def probe_tile_smem(row_bytes: int, l: int, cluster: int) -> int:
    """The dynamic shared memory of FlashProbe's tile-mode launch (rows of
    ``row_bytes``, lists of ``l``, clusters of ``cluster``), as the CUDA
    source computes it."""
    out = ctypes.c_int(0)
    check(lib().fk_flash_probe_tile_smem(row_bytes, l, cluster,
                                         ctypes.byref(out)),
          "fk_flash_probe_tile_smem")
    return int(out.value)


def lloyd_smem(is_bf16: bool, dp: int, k: int, cluster: int
               ) -> tuple[int, int]:
    """FlashLloyd's (dynamic, static) shared memory for the launch at padded
    width ``dp``, ``K`` and cluster size ``cluster``, read back from the
    kernel's attributes."""
    dyn, stat = ctypes.c_int(0), ctypes.c_int(0)
    check(lib().fk_flash_lloyd_smem(int(is_bf16), dp, k, cluster,
                                    ctypes.byref(dyn), ctypes.byref(stat)),
          "cudaFuncGetAttributes")
    return int(dyn.value), int(stat.value)
