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
SOURCES = ("lk.cu", "point_sample.cu", "response.cu", "orb_sample.cu", "ransac.cu", "refine.cu", "window.cu")
HEADERS = ("common.cuh", "small.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
# the solver kernels round every product and sum as their PyTorch plain
# versions' separate operations do (`csrc/small.cuh`)
SOURCE_FLAGS = {"ransac.cu": ("-fmad=false",), "refine.cu": ("-fmad=false",), "window.cu": ("-fmad=false",)}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: argtypes (every function returns cudaGetLastError() as int)
    # (per-call argument block, per-layout block): see csrc/point_sample.cu
    "dyno_point_sample": (_P, _P),
    "dyno_lk_level": (_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P),
    "dyno_shi_tomasi": (_P, _I, _I, _P, _P),
    "dyno_orb_sample": (_P, _P, _I, _I, _P, _I, _P, _P, _P, _P),
    "dyno_ransac": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "dyno_ransac_launch_shape": (_I, _I, _I, _I, _P),
    # (kind, float settings, int settings, pointers, stream): see csrc/refine.cu
    "dyno_refine_rounds": (_I, _P, _P, _P, _P),
    "dyno_refine_launch_shape": (_I, _I, _I, _P),
    # (pointer table, dims, float settings, stream): see csrc/window.cu
    "dyno_window_build": (_P, _P, _P, _P),
    "dyno_window_step": (_P, _P, _P, _P),
    "dyno_window_update": (_P, _P, _P, _P),
    "dyno_window_head": (_P, _P, _P, _P),
    "dyno_window_launch_shape": (_P, _P),
}


class _Library:
    """The loaded kernel library (one per process)."""

    lib = None
    functions: dict = {}
    logs: dict = {}    # source name: nvcc's output (ptxas' resource usage) of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode() + repr(sorted(SOURCE_FLAGS.items())).encode())
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
            cmd = [nvcc, *FLAGS, *SOURCE_FLAGS.get(name, ()), "-Xptxas", "-v", "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for name, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            _Library.logs[name] = log
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


def resource_usage(source: str) -> dict:
    """ptxas' report (`-Xptxas -v`) on each kernel of `source` from this
    process's build: {mangled kernel name: {"registers", "spill_stores",
    "spill_loads", "smem"} in registers and bytes}; empty where the library
    was not built in this process."""
    out, name = {}, None
    for line in _Library.logs.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name].update(spill_stores=nums[1], spill_loads=nums[2])
        elif name is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            out[name]["smem"] = int(words[words.index("smem") - 2]) if "smem" in words else 0
    return out


def function(name: str):
    """The library's C function `name`, looked up once per process."""
    fn = _Library.functions.get(name)
    if fn is None:
        fn = _Library.functions[name] = getattr(load(), name)
    return fn


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_handle(t) -> int:
    """The raw handle of the current CUDA stream on `t`'s device (the one a
    `torch.cuda.stream(...)` context selects), without building a Python
    stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
