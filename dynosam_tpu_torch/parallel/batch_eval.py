"""Multi-sequence batched evaluation: data parallelism over sequences
(port of `dynosam_tpu/parallel/batch_eval.py`).

The reference processes one sequence per run; this module steps a batch
of sequences in lockstep, frame by frame, and splits the batch over the
ranks of a mesh's frame axis (the JAX package shards the batch axis over
``frames``).  All sequences of a batch share an image resolution.

`torch.func.vmap` cannot map the hand-written kernels (ctypes launches)
or the frontend's host reads, so the batched step is a loop over the
rank's sequences, each through the port's `frontend_step` (K1, K2 and K3
once or more per sequence and frame).  Launching the sequences' work as
one stream is a speed item, not part of the port.

Randomness: one `torch.Generator` per sequence and frame, seeded by
`frame_seed(k, s)` (the counterpart of `jax.random.split(PRNGKey(k), S)`);
the RANSAC draws follow the port's randomness rule, so parity with the
JAX package is judged by accuracy, and a sequence's packets equal the
single-sequence `frontend_step` run under the same generators.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..frontend.frontend import FrontendState, frontend_step, to_device
from ..utils.config import FrontendConfig
from ..utils.device import resolve_device
from .mesh import FRAME_AXIS


def frame_seed(k: int, s: int) -> int:
    """Seed of sequence `s`'s generator at frame `k`."""
    return 1_000_003 * k + s


def frame_generator(k: int, s: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(frame_seed(k, s))
    return g


def stack_tree(items: Sequence):
    """Stack a list of equal-structure trees (NamedTuples of tensors) on a
    new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(items))
    return type(first)(*(stack_tree([getattr(it, f) for it in items]) for f in first._fields))


def make_batched_step(cfg: FrontendConfig, use_klt: bool = True, device=None):
    """step(states, prev_images, images, cams, generators, first_frame):
    lists with one entry per sequence (cams too: per-sequence intrinsics)
    -> (states, stacked packet, reports, ego results)."""
    dev = resolve_device(device)

    def step(states, prev_images, images, cams, generators, first_frame: bool):
        outs = [frontend_step(st, pv, im, cam, cfg, generator=g, use_klt=use_klt, first_frame=first_frame,
                              device=dev)
                for st, pv, im, cam, g in zip(states, prev_images, images, cams, generators)]
        new_states, packets, reports, egos = zip(*outs)
        return list(new_states), stack_tree(packets), list(reports), list(egos)

    return step


def shard_indices(n: int, mesh: Optional[DeviceMesh], axis_name: str = FRAME_AXIS) -> list:
    """The batch indices this rank owns when a batch of `n` splits
    contiguously over one mesh axis (all of them without a mesh)."""
    if mesh is None:
        return list(range(n))
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if n % size:
        raise ValueError(f"{n} sequences do not split over the {size}-way {axis_name} axis")
    b = n // size
    i = mesh.get_local_rank(axis_name)
    return list(range(i * b, (i + 1) * b))


def shard_batch(tree, mesh: Optional[DeviceMesh], axis_name: str = FRAME_AXIS):
    """This rank's block of a batched tree's leading axis (tensors of rank
    >= 1 split contiguously over one mesh axis; other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0:
            return tree
        idx = shard_indices(tree.shape[0], mesh, axis_name)
        return tree[idx[0]:idx[-1] + 1]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(x, mesh, axis_name) for x in tree))
    if isinstance(tree, (list, tuple)):
        idx = shard_indices(len(tree), mesh, axis_name)
        return type(tree)(tree[i] for i in idx)
    return tree


class MultiSequencePipeline:
    """Run S sequences in lockstep on one device, split over a mesh's
    frame axis when `mesh` is given (this rank steps its block of the
    sequences; `self.sequences` lists their indices)."""

    def __init__(self, datasets: Sequence, cfg: FrontendConfig, caps=(1200, 4096, 16), use_klt: bool = True,
                 mesh: Optional[DeviceMesh] = None, device=None):
        self.device = resolve_device(device)
        self.sequences = shard_indices(len(datasets), mesh)
        self.datasets = [datasets[i] for i in self.sequences]
        self.cfg = cfg
        self.mesh = mesh
        self.step = make_batched_step(cfg, use_klt, self.device)
        ns, nd, no = caps
        self.states = [FrontendState.create(ns, nd, no, device=self.device) for _ in self.datasets]
        self.cams = [d.camera_params() for d in self.datasets]
        sizes = {(c.width, c.height) for c in self.cams}
        if len(sizes) > 1:
            raise ValueError(f"the sequences of a batch must share one resolution, got {sorted(sizes)}")

    def run(self, n_frames: int) -> list:
        """Step every sequence `n_frames` times; returns one packet per
        frame, each leaf stacked over this rank's sequences."""
        iters = [d.frames() for d in self.datasets]
        prev = None
        packets = []
        for k in range(n_frames):
            frames = [to_device(next(it), self.device) for it in iters]
            if prev is None:
                prev = frames
            gens = [frame_generator(k, s, self.device) for s in self.sequences]
            self.states, pkt, _, _ = self.step(self.states, prev, frames, self.cams, gens, k == 0)
            packets.append(pkt)
            prev = frames
        return packets
