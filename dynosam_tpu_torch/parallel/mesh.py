"""Device mesh and placements for distributed BA on `torch.distributed`
(port of `dynosam_tpu/parallel/mesh.py`).

The trajectory (frame) axis is the data-parallel axis of dynamic SLAM:
keyframe blocks split over ``frames``; the dynamic track axis over
``tracks``.  Static landmarks are replicated over frames in the solve's
layout (they couple every frame).  One process (rank) drives one device;
a mesh is a `DeviceMesh` over the ranks of the default process group,
rank r at (r // T, r % T).

Placements are `torch.distributed.tensor` `Shard(d)` / `Replicate()`
pairs, one per mesh dim (frames, tracks), in trees shaped like the
`MeasurementMap` or the values dict: the layouts the JAX package writes as
`PartitionSpec`s.  The math works on plain tensors: `shard_map_data`
slices this rank's blocks out of a full map, `host_local_to_global`
gathers blocks back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..backend.map import MeasurementMap
from ..core.lie import SE3

FRAME_AXIS = "frames"
TRACK_AXIS = "tracks"


def mesh_shape(n: int, tracks: int | None = None) -> tuple:
    """(frames, tracks) sizes for n devices: `tracks` fixes the tracks
    axis (it must divide n); by default it gets a factor of 2 when n is even
    and at least 4, since the frame axis grows with the problem while the
    track pools are capacity-bounded."""
    if tracks is not None:
        if n % tracks != 0:
            raise ValueError(f"tracks axis {tracks} must divide {n} devices")
        return n // tracks, tracks
    if n % 2 == 0 and n >= 4:
        return n // 2, 2
    return n, 1


def make_mesh(n_devices: int | None = None, tracks: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """2D (frames x tracks) mesh over the ranks of the default process
    group, which must be initialised (`multihost.initialize`).  The mesh
    spans every rank (`n_devices`, when given, must be the world size);
    `device_type` defaults to the group's: "cuda" under NCCL, "cpu" under
    gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (multihost.initialize)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape(n, tracks), mesh_dim_names=(FRAME_AXIS, TRACK_AXIS))


def _spec(*dims):
    """Placements (frames, tracks) from a PartitionSpec-like list of the
    mesh axis sharding each tensor dim (None: not sharded)."""
    out = []
    for axis in (FRAME_AXIS, TRACK_AXIS):
        out.append(Shard(dims.index(axis)) if axis in dims else Replicate())
    return tuple(out)


def map_shardings(mesh: DeviceMesh | None = None) -> MeasurementMap:
    """The feeding layout: frame-indexed arrays split over frames, the
    dynamic track axis over tracks, static slots replicated over tracks."""
    f = _spec
    FA, TA = FRAME_AXIS, TRACK_AXIS
    return MeasurementMap(
        static_xyz=f(FA, None, None), static_uv=f(FA, None, None), static_valid=f(FA, None),
        dyn_xyz=f(FA, TA, None), dyn_uv=f(FA, TA, None), dyn_obj=f(FA, TA), dyn_valid=f(FA, TA),
        X_init=SE3(f(FA, None, None), f(FA, None)), timestamps=f(FA), frame_ids=f(FA), frame_valid=f(FA),
        motion_init=SE3(f(FA, None, None, None), f(FA, None, None)), motion_valid=f(FA, None),
        obj_pose_init=SE3(f(FA, None, None, None), f(FA, None, None)), obj_label=f(FA, None),
    )


def map_compute_shardings(mesh: DeviceMesh | None = None) -> MeasurementMap:
    """The layout the distributed Schur solve consumes: static grids split
    over tracks and replicated over frames (the static family couples every
    frame to the same landmark), dynamic grids (frames x tracks), pose and
    per-frame arrays replicated."""
    f = _spec
    FA, TA = FRAME_AXIS, TRACK_AXIS
    return MeasurementMap(
        static_xyz=f(None, TA, None), static_uv=f(None, TA, None), static_valid=f(None, TA),
        dyn_xyz=f(FA, TA, None), dyn_uv=f(FA, TA, None), dyn_obj=f(FA, TA), dyn_valid=f(FA, TA),
        X_init=SE3(f(), f()), timestamps=f(), frame_ids=f(), frame_valid=f(),
        motion_init=SE3(f(), f()), motion_valid=f(), obj_pose_init=SE3(f(), f()), obj_label=f(),
    )


def values_shardings(mesh: DeviceMesh | None = None, formulation: int = 0) -> dict:
    """Placements of the values dict (X, H or L, sp, dp)."""
    f = _spec
    FA, TA = FRAME_AXIS, TRACK_AXIS
    return {
        "X": SE3(f(FA, None, None), f(FA, None)),
        "H" if formulation == 0 else "L": SE3(f(FA, None, None, None), f(FA, None, None)),
        "sp": f(None, None),
        "dp": f(FA, TA, None),
    }


def partition_spec(placements) -> tuple:
    """The PartitionSpec-like tuple of a placement pair: per tensor dim the
    mesh axis that splits it, trailing unsplit dims dropped."""
    dims = {}
    for axis, p in zip((FRAME_AXIS, TRACK_AXIS), placements):
        if isinstance(p, Shard):
            dims[p.dim] = axis
    return tuple(dims.get(d) for d in range(max(dims) + 1)) if dims else ()


def mesh_coords(mesh: DeviceMesh) -> tuple:
    """(frame block, track block) of this rank, and the mesh sizes."""
    return (mesh.get_local_rank(FRAME_AXIS), mesh.get_local_rank(TRACK_AXIS),
            mesh.size(0), mesh.size(1))


def _block(x: torch.Tensor, placements, coords) -> torch.Tensor:
    fi, ti, F, T = coords
    for idx, n, p in ((fi, F, placements[0]), (ti, T, placements[1])):
        if isinstance(p, Shard):
            size = x.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of size {size} does not split into {n} blocks")
            b = size // n
            x = x.narrow(p.dim, idx * b, b)
    return x


def _is_placement(p) -> bool:
    return isinstance(p, tuple) and len(p) == 2 and all(isinstance(q, (Shard, Replicate)) for q in p)


def tree_map2(fn, tree, spec):
    """fn(leaf, placements) over a tree of tensors and the matching tree of
    placement pairs (NamedTuples, dicts)."""
    if _is_placement(spec):
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: tree_map2(fn, tree[k], spec[k]) for k in tree}
    return type(tree)(*(tree_map2(fn, a, s) for a, s in zip(tree, spec)))


class ShardedMap(NamedTuple):
    """This rank's blocks of a MeasurementMap of `n_frames` frames in one
    layout ("feed" or "compute")."""

    local: MeasurementMap
    layout: str
    n_frames: int


def shard_map_data(m: MeasurementMap, mesh: DeviceMesh, layout: str = "feed") -> ShardedMap:
    """This rank's blocks of the full map `m` (held by every rank) in the
    feeding layout (`map_shardings`) or the solve's (`map_compute_shardings`)."""
    spec = map_shardings(mesh) if layout == "feed" else map_compute_shardings(mesh)
    coords = mesh_coords(mesh)
    local = tree_map2(lambda x, p: _block(x, p, coords), m, spec)
    return ShardedMap(local, layout, m.frame_valid.shape[0])


# ------------------------------------------------------------ collectives
# Every collective of the parallel layer goes through these three, each
# one `torch.distributed` call.


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Concatenate every rank's `x` of `group` (size n) along dim 0: one
    all_gather (bool travels as uint8)."""
    if n == 1:
        return x
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = src.new_empty((n * x.shape[0], *x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out.to(x.dtype)


def all_reduce_packed(tree: dict, group=None) -> dict:
    """Sum a dict of same-dtype tensors over `group` as ONE flat vector
    (one all_reduce instead of one per leaf)."""
    keys = list(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in keys])
    dist.all_reduce(flat, group=group)
    out, off = {}, 0
    for k in keys:
        n = tree[k].numel()
        out[k] = flat[off:off + n].reshape(tree[k].shape)
        off += n
    return out


def exchange(group, left: int | None, right: int | None, to_left=None, to_right=None):
    """One batched point-to-point exchange with the ranks `left` and
    `right` (global ranks, None at the chain's ends): sends `to_left` /
    `to_right` and returns what those neighbours sent this way, zeros
    where a neighbour is missing (as `ppermute` fills missing sources)."""
    ops, got = [], [None, None]
    # what the left neighbour sends this way has the shape of `to_right`
    for i, (peer, like) in enumerate(((left, to_right), (right, to_left))):
        if like is not None:
            got[i] = torch.zeros_like(like)
            if peer is not None:
                ops.append(dist.P2POp(dist.irecv, got[i], peer, group))
    for peer, out in ((left, to_left), (right, to_right)):
        if peer is not None and out is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return got[0], got[1]


def host_local_to_global(local_arrays, mesh: DeviceMesh, axis: str = FRAME_AXIS):
    """Assemble per-rank blocks split along dim 0 over one mesh axis into
    the global tensors, on every rank (one all_gather per leaf)."""
    group = mesh.get_group(axis)
    n = mesh.size(mesh.mesh_dim_names.index(axis))

    def put(x):
        return all_gather_rows(x, group, n) if isinstance(x, torch.Tensor) else type(x)(*map(put, x))

    if isinstance(local_arrays, dict):
        return {k: put(v) for k, v in local_arrays.items()}
    return put(local_arrays)
