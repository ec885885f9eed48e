"""K5 — the frontend's refinement rounds (outlier rounds around a
block-eliminated LM) on the device, one thread block cluster per problem,
with no host read.

Replaces no Pallas kernel: it is the counterpart of the JAX package's nested
`lax.while_loop`s, `dynosam_tpu/frontend/refine.py:57`
(`optimize_flow_and_pose`) and `:186` (`optimize_motion_only`) around
`dynosam_tpu/backend/small_schur.py:88` (`lm_optimize_eliminated`).  The
port ran them as host loops of small operators that read the rounds' and
the LM's flags (`frontend/refine.py:rounds_schedule`, about 4,700
operators and 14 host reads a frame).  CUDA source: `csrc/refine.cu` (the
contract is stated there).

`rounds(kid, fparams, iparams, rows, start, glob0, shared, valid)` launches
the kernel on the arguments `frontend/refine.py:pack` lays out and returns
its outputs, which `frontend/refine.py:unpack` reads back.  K5's wrapper is
`frontend/refine.py:run_rounds`: it launches K5 for CUDA tensors and runs
the plain version, `frontend/refine.py:rounds_plain` (the host loops), for
CPU tensors.  `rounds` takes CUDA float32 tensors only and raises on any
other, and on more rows than `launch_shape` says the kernel takes (the
shared memory of 8 CTAs holds every row's state); there is no fallback.

Bound on the card: latency -- each LM iteration is a chain of two sums
over the rows and a 6x6 solve, up to `outlier_rounds` + 1 rounds of
`max_iterations` LM iterations a problem (5 of 5 by default); the FLOPs
(hundreds to thousands a row an iteration) are microseconds of the card's
rate.  A problem's rows are spread over a cluster of up to 8 CTAs, about
one a thread, with every per-row state in shared memory; the sums are
fixed-order over the cluster, so a result repeats bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0   # calls of `rounds` that launched the kernel

FLOW_POSE, MOTION_ONLY = 0, 1   # the kernel's kind ids


def launch_shape(kid: int, bsz: int, n: int) -> dict:
    """How K5 launches for `bsz` problems of `n` rows on the current CUDA
    device: cluster size, CTAs, threads a CTA, dynamic shared memory a CTA
    (bytes), and the most rows a problem may have (`max_rows`)."""
    out = (ctypes.c_int * 5)()
    build.check(build.function("dyno_refine_launch_shape")(kid, bsz, n, out), "refine_rounds launch shape")
    return dict(zip(("cluster", "ctas", "threads", "smem", "max_rows"), out))


def rounds(kid: int, fparams: tuple, iparams: tuple, rows, start, glob0, shared, valid):
    """Launch K5 (see the module docstring): returns carried (B, N, b),
    active (B, N), glob (B, 12), error (B,), n_new and it (B,) int64."""
    global launches
    tensors = (rows, start, glob0, shared, valid)
    if rows.device.type != "cuda":
        raise ValueError("K5 takes CUDA tensors; on the CPU frontend/refine.py:run_rounds runs rounds_plain")
    dev = rows.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors[:4]) or valid.dtype != torch.bool:
        raise ValueError("the kernel takes float32 tensors and a bool active mask")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    bsz, n = valid.shape
    b = start.shape[-1]
    if rows.shape[:2] != (bsz, n) or start.shape[:2] != (bsz, n) or glob0.shape != (bsz, 12):
        raise ValueError("rows, start and glob0 must lead with the problems' (B, N)")
    max_rows = launch_shape(kid, bsz, n)["max_rows"]
    if n > max_rows:
        raise ValueError(f"K5 takes at most {max_rows} rows a problem on this card (got {n})")
    carried = torch.empty((bsz, n, b), dtype=torch.float32, device=rows.device)
    active = torch.empty((bsz, n), dtype=torch.bool, device=rows.device)
    glob = torch.empty((bsz, 12), dtype=torch.float32, device=rows.device)
    error = torch.empty((bsz,), dtype=torch.float32, device=rows.device)
    n_new = torch.empty((bsz,), dtype=torch.int64, device=rows.device)
    it = torch.empty((bsz,), dtype=torch.int64, device=rows.device)
    ptrs = (rows, start, glob0, None if kid == FLOW_POSE else shared, valid, carried, active, glob, error, n_new, it)
    code = build.function("dyno_refine_rounds")(
        kid, (ctypes.c_float * 18)(*fparams), (ctypes.c_int * 4)(*iparams, bsz, n),
        (ctypes.c_longlong * 11)(*(0 if t is None else t.data_ptr() for t in ptrs)), build.stream_handle(rows),
    )
    build.check(code, "refine_rounds")
    launches += 1
    return carried, active, glob, error, n_new, it
