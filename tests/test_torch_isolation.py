"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card, and importing it needs no CUDA toolkit."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def _run(code, env_extra=None):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    out = _run(_IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 14
    assert bad == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b|"
    r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s)|from\s+repro\s+import)",
    re.MULTILINE)


def test_no_source_file_imports_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "tools" / "train_profile.py"]
    assert len(files) >= 15
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_the_scan_catches_each_forbidden_form():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.kernels import ops", "from repro import core",
                 "  import jax.numpy as jnp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import KMeans"):
        assert not _FORBIDDEN.search(line), line


def test_kmeans_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.core import KMeans, KMeansConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KMeans(KMeansConfig(k=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        KMeans(KMeansConfig(k=4), device="cuda")
    assert KMeans(KMeansConfig(k=4), device="cpu").device.type == "cpu"


def test_kernel_modules_import_without_nvcc():
    code = ("import repro_torch.kernels.ops, repro_torch.kernels._build as b\n"
            "import repro_torch.kernels.flash_assign, "
            "repro_torch.kernels.flash_lloyd, "
            "repro_torch.kernels.sort_inverse_update, "
            "repro_torch.kernels.flash_probe, "
            "repro_torch.kernels.rescore_cache, repro_torch.index, "
            "repro_torch.serve, repro_torch.launch.serve\n"
            "print(b._lib is None)")
    out = _run(code, {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"  # nothing was built or loaded


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        assert _build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()


def test_every_kernel_source_is_listed_for_the_build():
    from repro_torch.kernels import _build
    names = {p.name for p in _build.sources()}
    assert names == {"flash_assign.cu", "sort_inverse_update.cu",
                     "flash_lloyd.cu", "flash_probe.cu", "rescore_cache.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert len(_build.source_hash()) == 16
    mods = {m.name for m in pkgutil.iter_modules(
        [str(SRC / "repro_torch" / "kernels")])}
    assert {"ref", "ops", "flash_assign", "sort_inverse_update",
            "flash_lloyd", "flash_probe", "rescore_cache", "_build"} <= mods


_RAW_STORE = re.compile(r"\.(buckets|bucket_ids|bucket_aux|pool|pool_ids"
                        r"|pool_aux|tables|tables_np|pages_np|last_touch"
                        r"|_free)\b")


def test_zero_raw_bucket_tensor_sites_outside_store():
    """The reference's architecture guard (``tests/index/test_store.py``)
    over the port and ``chip_smoke.py``: outside ``index/store.py`` no code
    reads or writes a raw posting-list tensor or allocator attribute; the
    search reads the store through its ``scan_view``."""
    store = SRC / "repro_torch" / "index" / "store.py"
    files = [f for f in sorted((SRC / "repro_torch").rglob("*.py"))
             if f != store] + [ROOT / "chip_smoke.py"]
    offenders = []
    for f in files:
        for lineno, line in enumerate(f.read_text().splitlines(), 1):
            if _RAW_STORE.search(line.split("#", 1)[0]):
                offenders.append(f"{f.relative_to(ROOT)}:{lineno}: "
                                 f"{line.strip()}")
    assert not offenders, "\n".join(offenders)
