"""Instance-mask helpers (port of `label_counts` from
`dynosam_tpu/frontend/mask_ops.py`; mask propagation waits for the
alternate-modes slice)."""

from __future__ import annotations

import torch


def label_counts(mask: torch.Tensor, label_cap: int) -> torch.Tensor:
    """Pixel count per instance label, labels clipped to [0, label_cap):
    (label_cap,) int32."""
    lab = torch.clamp(mask.reshape(-1), 0, label_cap - 1).long()
    return torch.bincount(lab, minlength=label_cap).to(torch.int32)
