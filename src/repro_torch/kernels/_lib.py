"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (headers they share, ``csrc/*.cuh``,
count towards the build's hash).  At first use each one is compiled
by its own ``nvcc`` process for ``sm_90a`` (all started together), the
objects are linked into one shared library under ``kernels/build/``
(listed in ``.gitignore``), and the library is loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing here
runs at import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_agg_blend.cu", "dual_proximal_sgd.cu",
           "flash_attention.cu", "flash_attention_bwd.cu", "slstm_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_fused_agg_blend": (_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _LL,
                              _I, _I, _I, _P),
    "repro_agg_blend": (_P, _P, _P, _P, _I, _I, _LL, _P, _P, _P, _I, _I,
                        _P),
    "repro_weighted_agg_matmul": (_P, _P, _P, _I, _I, _LL, _I, _I, _P),
    "repro_dual_proximal_sgd": (_P, _P, _P, _P, _I, _P, _I, _P, _LL, _I,
                                _LL, _F, _F, _F, _P, _P, _P, _I, _I, _P),
    "repro_flash_attention": (_P, _P, _P, _P, _P, *(_I,) * 7,
                              *(_LL,) * 9, _I, _I, _I, _P),
    "repro_flash_attention_split": (*(_P,) * 7, *(_I,) * 7, *(_LL,) * 9,
                                    _P),
    "repro_flash_attention_split_occupancy": (_I, _P),
    "repro_flash_attention_bwd": (*(_P,) * 12, *(_I,) * 7, _P),
    "repro_slstm_scan": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_slstm_scan_plan": (_I, _I, _I, _P, _P),
}


class _Library:
    """The loaded shared library plus what its build reported."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None   # None: reused a build
        self.ptxas_log = ""


_STATE = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path.  Reuses a library already built from these sources.
    Processes that build at once (the ranks of a sharded run) take turns
    on a file lock, so one builds and the others reuse its library."""
    tag = _digest()
    so = BUILD_DIR / f"librepro_torch_kernels_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile(so)
    return so


def _compile(so: Path) -> None:
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for name, proc in procs:
            out, err = proc.communicate()
            logs.append(f"== {name}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs))
        linked = Path(tmp) / so.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(linked)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(linked, so)
    _STATE.build_seconds = time.perf_counter() - t0
    _STATE.ptxas_log = "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    if _STATE.lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _STATE.lib = lib
    return _STATE.lib


def build_report() -> dict:
    """Build time in seconds (None when a previous build was reused) and
    the compiler's per-kernel register / shared-memory report."""
    return {"build_seconds": _STATE.build_seconds,
            "ptxas_log": _STATE.ptxas_log}


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
