"""K6 — the frontend's motion RANSAC (3d2d PnP and 3d3d Arun), scored and
polished on the device.

Replaces no Pallas kernel: it is the counterpart of the JAX package's fused,
vmapped `dynosam_tpu/ops/ransac.py:165` (`ransac_rigid`) and `:314`
(`ransac_pose_3d2d`), which the port ran as about 1,400 small operators a
call (`ops/ransac.py:hypotheses_and_polish_plain`).  CUDA source:
`csrc/ransac.cu` (the contract is stated there).

`ransac(src, dst, valid, idx, uv, cam, threshold, refine_steps,
min_inliers)` takes B problems after `ops/ransac.py:ransac_rigid` has drawn
the hypotheses (`sample_valid_indices`) and, with `score_cap`, compacted
the rows; the scatter back through the compaction order stays there too.
It returns (R (B, 3, 3), t (B, 3), inliers (B, N) bool, n_inliers (B,)
int32, status (B,) int32).  K6's wrapper is
`ops/ransac.py:hypotheses_and_polish`: it launches K6 for CUDA tensors and
runs the plain version, `ops/ransac.py:hypotheses_and_polish_plain`, for
CPU tensors.  `ransac` takes CUDA float32 tensors only and raises on any
other; there is no fallback.  Each call counts one launch (the score and
polish kernels back to back).  The hypotheses' rows must lie in [0, N), as
`sample_valid_indices` draws them; the kernel does not check them.

Bound on the card: the polish's latency -- five dependent sums over the
rows and 6x6 solves a problem; the scoring's ~0.1 GFLOP at the main
path's shapes is 1.5 us of the card's float32 rate.  A block stages a
problem's rows in shared memory and its warps score a few hypotheses,
each over a share of the rows (integer counts, exact in any order); a
cluster of up to 8 CTAs polishes a problem with fixed-order sums, so a
result repeats bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0   # calls of `ransac` that launched the kernels


def launch_shape(bsz: int, n: int, k: int, reproj: bool) -> dict:
    """How K6 launches for `bsz` problems of `n` rows and `k` hypotheses on
    the current CUDA device: scoring blocks, threads a block and warps a
    hypothesis; the polish's cluster size, CTAs, threads a CTA and dynamic
    shared memory a CTA (bytes)."""
    out = (ctypes.c_int * 7)()
    build.check(build.function("dyno_ransac_launch_shape")(bsz, n, k, int(reproj), out), "ransac launch shape")
    return dict(zip(("score_blocks", "score_threads", "score_warps", "cluster", "ctas", "threads", "smem"), out))


def pack(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor, uv):
    """The kernel's arguments: contiguous (B, N, 3) src and dst, (B, N)
    bool valid, (B, K, 3) int64 hypothesis rows with K > 0, and (B, N, 2)
    uv or None (3d3d)."""
    b, n = src.shape[:2]
    if src.shape != (b, n, 3) or dst.shape != (b, n, 3) or valid.shape != (b, n):
        raise ValueError("src and dst must be (B, N, 3) and valid (B, N)")
    if idx.dim() != 3 or idx.shape[0] != b or idx.shape[2] != 3:
        raise ValueError("idx must be (B, K, 3)")
    if idx.shape[1] == 0:
        raise ValueError("idx holds no hypothesis (K = 0)")
    if uv is not None and uv.shape != (b, n, 2):
        raise ValueError("uv must be (B, N, 2)")
    if valid.dtype != torch.bool:
        raise ValueError("valid must be bool")
    return (src.contiguous(), dst.contiguous(), valid.contiguous(), idx.long().contiguous(),
            None if uv is None else uv.contiguous())


def ransac(src, dst, valid, idx, uv, cam, threshold: float, refine_steps: int = 5, min_inliers: int = 5,
           counts=None):
    """Launch K6 (see the module docstring).  `counts`, a (B, K) int32
    tensor on the inputs' device, receives the hypotheses' inlier counts (a
    check reads them); by default the kernel keeps them in scratch."""
    global launches
    if src.device.type != "cuda":
        raise ValueError("K6 takes CUDA tensors; on the CPU ops/ransac.py:hypotheses_and_polish runs "
                         "hypotheses_and_polish_plain")
    src, dst, valid, idx, uv = pack(src, dst, valid, idx, uv)
    tensors = (src, dst, valid, idx) + (() if uv is None else (uv,))
    dev = src.get_device()
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if src.dtype != torch.float32 or dst.dtype != torch.float32 or (uv is not None and uv.dtype != torch.float32):
        raise ValueError("the kernel takes float32 src, dst and uv")
    if uv is not None and cam is None:
        raise ValueError("the 3d2d mode needs the camera")
    b, n = src.shape[:2]
    k = idx.shape[1]
    if counts is None:
        counts = torch.empty((b, k), dtype=torch.int32, device=src.device)
    elif counts.shape != (b, k) or counts.dtype != torch.int32 or not counts.is_contiguous() \
            or counts.get_device() != dev:
        raise ValueError("counts must be a contiguous (B, K) int32 tensor on the inputs' device")
    R = src.new_empty((b, 3, 3))
    t = src.new_empty((b, 3))
    inliers = torch.empty((b, n), dtype=torch.bool, device=src.device)
    n_inl = torch.empty((b,), dtype=torch.int32, device=src.device)
    status = torch.empty((b,), dtype=torch.int32, device=src.device)
    fx, fy, cx, cy = (0.0, 0.0, 0.0, 0.0) if cam is None else (cam.fx, cam.fy, cam.cx, cam.cy)
    code = build.function("dyno_ransac")(
        src.data_ptr(), dst.data_ptr(), 0 if uv is None else uv.data_ptr(), valid.data_ptr(), idx.data_ptr(),
        b, n, k, fx, fy, cx, cy, float(threshold), int(refine_steps), int(min_inliers), counts.data_ptr(),
        R.data_ptr(), t.data_ptr(), inliers.data_ptr(), n_inl.data_ptr(), status.data_ptr(),
        build.stream_handle(src),
    )
    build.check(code, "ransac")
    launches += 1
    return R, t, inliers, n_inl, status
