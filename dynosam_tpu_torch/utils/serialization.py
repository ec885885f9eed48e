"""Frontend packet serialisation and solver checkpoints (port of
`dynosam_tpu/utils/serialization.py`).

`save_packets` stacks every `FrontendOutput` and writes one compressed npz
whose leaves are numbered in the JAX package's pytree order (NamedTuple
fields depth first, `SE3` as R then t), so either package reads the
other's files; `load_packets` replays them through the backend with no
vision.  Solver state is one `torch.save` file of named tensors
(`save_checkpoint`), restored onto the template's structure and devices
(`load_checkpoint`; the JAX package uses orbax).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.types import FrontendOutput, stack_outputs
from .device import resolve_device


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def _unflatten(template, leaves):
    """`template`'s structure (NamedTuples, dicts, tensors) with its tensors
    taken in order from the iterator `leaves`."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves) for k, v in template.items()}
    return type(template)(*(_unflatten(v, leaves) for v in template))


def save_packets(path: str, packets: List[FrontendOutput]) -> None:
    stacked = [x.detach().cpu().numpy() for x in _leaves(stack_outputs(packets))]
    np.savez_compressed(path, n=len(packets), **{f"leaf_{i}": a for i, a in enumerate(stacked)})


def load_packets(path: str, device=None) -> List[FrontendOutput]:
    """The packets of `path` on `device` (CUDA unless the caller asks for
    another)."""
    dev = resolve_device(device)
    data = np.load(path)
    n = int(data["n"])
    n_leaves = len(_leaves(FrontendOutput.empty(1, 1, 1)))
    stacked = [torch.as_tensor(data[f"leaf_{i}"]).to(dev) for i in range(n_leaves)]
    template = FrontendOutput.empty(1, 1, 1)
    return [_unflatten(template, iter([a[k] for a in stacked])) for k in range(n)]


def save_checkpoint(path: str, state) -> None:
    """Every tensor of `state` (nested dicts and NamedTuples) under its
    position, in one file."""
    torch.save({str(i): t.detach().cpu() for i, t in enumerate(_leaves(state))}, path)


def load_checkpoint(path: str, template):
    """The saved tensors on `template`'s structure, each moved to the device
    of the template tensor it replaces; shapes and dtypes must match."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    tmpl = _leaves(template)
    if len(saved) != len(tmpl):
        raise ValueError(f"checkpoint {path} holds {len(saved)} tensors, the template {len(tmpl)}")
    out = []
    for i, t in enumerate(tmpl):
        s = saved[str(i)]
        if s.shape != t.shape or s.dtype != t.dtype:
            raise ValueError(f"checkpoint tensor {i}: {tuple(s.shape)} {s.dtype}, "
                             f"the template has {tuple(t.shape)} {t.dtype}")
        out.append(s.to(t.device))
    return _unflatten(template, iter(out))
