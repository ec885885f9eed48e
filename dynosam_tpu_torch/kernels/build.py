"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Route: `nvcc` compiles each source for sm_90a into an object file (all
sources at once, one process each), one more `nvcc` links them into a
shared library with a plain C interface, and `ctypes` loads it.  The
library lands in `build/kernels/` at the repository root (git-ignored),
named by a hash of the sources and flags, so a source change rebuilds and
an unchanged tree reuses the library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("lk.cu", "point_sample.cu", "response.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: argtypes (every function returns cudaGetLastError() as int)
    "dyno_point_sample": (_P, _I, _I, _I, _P, _P, _I, _I, _P, _P),
    "dyno_lk_level": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "dyno_lk_smem_bytes": (_I,),
    "dyno_shi_tomasi": (_P, _I, _I, _P, _P),
}


class _Library:
    """The loaded kernel library (one per process)."""

    lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources if the hashed library is missing; returns its
    path.  Raises with the compiler's output on failure."""
    out = BUILD_DIR / f"libdynosam_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for name, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            if verbose:
                print(f"[nvcc {name}]\n{log}", flush=True)
            objs.append(str(obj))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", *objs, "-o", str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)
    return out


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use."""
    if _Library.lib is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _Library.lib = lib
    return _Library.lib


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_handle(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
