"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into ``tpu_vp9_torch/_build/lib<name>.so``
and loaded with ``ctypes``; it is rebuilt when the source, or any shared
header ``csrc/*.cuh``, is newer than the library. ``build_all`` compiles
several sources at once, one nvcc process each. The directory is listed
in ``.gitignore``. The compiler's output (ptxas register and
shared-memory report included) is kept beside the library as
``lib<name>.log``. ``build_source`` compiles a source given as text (a
profiling copy of a kernel) the same way.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> seconds nvcc took in this process (0.0 when the library was
# already up to date)
build_seconds: dict[str, float] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the port's CUDA kernels cannot be built")
    return path


def _stale(name: str) -> bool:
    """The library is missing or older than its source or than any shared
    header of ``csrc/`` (a source may include any of them)."""
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(so):
        return True
    newest = max(os.path.getmtime(p) for p in
                 [os.path.join(CSRC, f"{name}.cu"),
                  *glob.glob(os.path.join(CSRC, "*.cuh"))])
    return newest > os.path.getmtime(so)


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu``; returns (process, tmp path, t0)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, proc, tmp: str, t0: float) -> None:
    out, err = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, f"lib{name}.log"), "w") as fh:
        fh.write(out + err)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{err}")
    # atomic: a concurrent loader sees the old library or the new one
    os.replace(tmp, os.path.join(BUILD_DIR, f"lib{name}.so"))


def build_all(names) -> None:
    """Compile every stale ``csrc/<name>.cu`` of ``names`` at once, one
    nvcc process per source, and wait for all of them."""
    started = {name: _start(name) for name in names if _stale(name)}
    for name in names:
        build_seconds.setdefault(name, 0.0)
    failed = []
    for name, job in started.items():  # wait for every nvcc, then raise
        try:
            _finish(name, *job)
        except RuntimeError as exc:
            failed.append(str(exc))
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Load ``lib<name>.so``, compiling ``csrc/<name>.cu`` first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
    _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler output of the last build of ``csrc/<name>.cu``."""
    path = os.path.join(BUILD_DIR, f"lib{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def build_source(src: str, name: str):
    """Write ``src`` to ``_build/<name>.cu``, compile it with the port's
    flags (``csrc/`` on the include path) into ``lib<name>.so`` and load
    it; returns the library and ptxas's register and spill lines. Raises
    if nvcc fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = os.path.join(BUILD_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    with open(cu, "w") as fh:
        fh.write(src)
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", so, cu],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{res.stderr}")
    report = [ln.strip() for ln in res.stderr.splitlines()
              if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), report
