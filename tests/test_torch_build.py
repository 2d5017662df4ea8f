"""The kernel build is safe across processes (``kernels/_build.py``).

Ranks started together (``torchrun``, or ``chip_smoke.py``'s spawned ranks)
all call ``_build.build()`` at once. The build takes an ``flock`` around
its check-compile-link sequence and names its object files by process, so
one process compiles and the others load what it linked. Checked here on
the CPU with a stand-in ``nvcc`` (found through ``CUDA_HOME``) that logs
each call and writes placeholder objects slowly enough for the processes
to overlap.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FAKE_NVCC = """\
#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + " "
            + str(os.getppid()) + " " + os.path.basename(out) + "\\n")
time.sleep(0.3)
with open(out, "w") as f:
    f.write("built by " + str(os.getppid()))
"""

BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from repro_torch.kernels import _build
    _build.BUILD_ROOT = Path(sys.argv[1])
    print(_build.build(), flush=True)
""")


def _setup(tmp_path):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_HOME": str(tmp_path / "cuda")}
    return env, log, tmp_path / "build"


def _start(env, root):
    return subprocess.Popen([sys.executable, "-c", BUILD, str(root)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(p):
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    return out.strip(), p.pid


def test_racing_builds_compile_once_and_share_the_library(tmp_path):
    from repro_torch.kernels import _build
    env, log, root = _setup(tmp_path)
    procs = [_start(env, root) for _ in range(3)]
    results = [_finish(p) for p in procs]
    paths = {path for path, _ in results}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.name == "libfkmeans.so" and lib.is_file()
    calls = [line.split() for line in log.read_text().splitlines()]
    compiles = [c for c in calls if c[0] == "compile"]
    links = [c for c in calls if c[0] == "link"]
    n_src = len(_build.sources())
    assert len(compiles) == n_src and len(links) == 1
    makers = {c[1] for c in compiles} | {c[1] for c in links}
    assert len(makers) == 1 and int(makers.pop()) in {
        pid for _, pid in results}
    # object files are named by the building process, then removed
    assert all(c[2].endswith(f".{compiles[0][1]}.o") for c in compiles)
    assert not list(lib.parent.glob("*.o"))
    assert lib.read_text() == f"built by {links[0][1]}"
    # a later process finds the finished library and compiles nothing
    again, _ = _finish(_start(env, root))
    assert again == str(lib)
    assert len(log.read_text().splitlines()) == len(calls)


def test_a_failed_compile_leaves_no_library_for_the_next_process(tmp_path):
    env, log, root = _setup(tmp_path)
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nsys.exit(1)\n")
    p = _start(env, root)
    _, err = p.communicate(timeout=120)
    assert p.returncode != 0 and "KernelUnavailable" in err
    assert not list(root.rglob("libfkmeans.so"))
