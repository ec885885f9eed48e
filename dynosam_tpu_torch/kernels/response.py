"""K3 — fused Shi-Tomasi (minimum-eigenvalue) corner response.

Replaces the Pallas kernel
`dynosam_tpu/ops/pallas/response.py:shi_tomasi_response_pallas` (body
`_response_kernel`) and reproduces the frontend's
`dynosam_tpu/frontend/detect.py:shi_tomasi_response_fast` everywhere,
borders included: Sobel x 1/8 on the edge-replicated image, 5x5 box sums of
the gradient products taken as zero outside the image and divided by 25,
then lambda_min.  CUDA source: `csrc/response.cu`.

Bound on the card: bytes — one read and one write per pixel.  The kernel
computes one 32x16 tile per block from a 3-pixel-halo tile in shared memory,
so no intermediate image reaches device memory.

The plain version takes the box sums directly (a separable sum of shifted
copies); `_fast`'s f32 integral image carries cancellation error that a
direct sum does not, so the two agree to a tolerance relative to
max |response|, not bit for bit.

`shi_tomasi_response` launches the kernel for CUDA tensors and runs
`shi_tomasi_response_plain` for CPU tensors; there is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

launches = 0   # kernel launches by `shi_tomasi_response` (CUDA tensors only)


def sobel_gradients_fast(gray: torch.Tensor):
    """Sobel x 1/8 with edge replication (`detect.sobel_gradients_fast`)."""
    h, w = gray.shape
    p = F.pad(gray[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    tl, tc, tr = sh(-1, -1), sh(-1, 0), sh(-1, 1)
    ml, mr = sh(0, -1), sh(0, 1)
    bl, bc, br = sh(1, -1), sh(1, 0), sh(1, 1)
    ix = ((tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)) / 8.0
    iy = ((bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)) / 8.0
    return ix, iy


def box_sum(img: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box sum with the image taken as zero outside (the value of
    `detect._box_sum`'s integral image), as a separable direct sum."""
    h, w = img.shape
    p = F.pad(img, (r, r, r, r))
    rows = sum(p[dy:dy + h, :] for dy in range(2 * r + 1))
    return sum(rows[:, dx:dx + w] for dx in range(2 * r + 1))


def shi_tomasi_response_plain(gray: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    ix, iy = sobel_gradients_fast(gray)
    r = window // 2
    n = float(window * window)
    sxx = box_sum(ix * ix, r) / n
    syy = box_sum(iy * iy, r) / n
    sxy = box_sum(ix * iy, r) / n
    tr = sxx + syy
    det_rad = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy * sxy, min=0.0))
    return 0.5 * (tr - det_rad)


def shi_tomasi_response(gray: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: (H, W) float32 -> (H, W) float32 response (5x5 window)."""
    global launches
    if gray.dim() != 2 or gray.dtype != torch.float32:
        raise ValueError("gray must be (H, W) float32")
    if gray.device.type == "cpu":
        return shi_tomasi_response_plain(gray)
    if gray.device.type != "cuda":
        raise ValueError("gray must lie on a CUDA device")
    gray = gray.contiguous()
    h, w = gray.shape
    out = torch.empty_like(gray)
    code = build.load().dyno_shi_tomasi(
        gray.data_ptr(), h, w, out.data_ptr(), build.stream_handle(gray)
    )
    build.check(code, "shi_tomasi_response")
    launches += 1
    return out
