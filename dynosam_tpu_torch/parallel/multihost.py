"""Multi-host / multi-process distribution layer on `torch.distributed`
(port of `dynosam_tpu/parallel/multihost.py`).

One process per device: `initialize` joins the process group (NCCL for a
CUDA run, gloo for a CPU run; no fallback from one to the other),
`global_mesh` lays the ranks out as (frames x tracks) with the frame axis
across hosts and the tracks axis inside each host, and
`feed_measurement_map` turns each rank's own keyframe rows into the
solve's layout.

Mesh layout policy: the FRAME axis is the cross-host axis.  Each process
owns a contiguous keyframe block, so the SPIKE chain elimination's
exchanges (`schur_dist.py`) cross hosts once per block boundary per LM
iteration; the tracks axis stays inside a host, where chains never
communicate.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from torch.distributed.tensor import Shard

from ..backend.map import MeasurementMap
from ..utils.device import resolve_device
from .mesh import (
    FRAME_AXIS,
    ShardedMap,
    all_gather_rows,
    make_mesh,
    map_compute_shardings,
    map_shardings,
    mesh_coords,
    tree_map2,
)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> torch.device:
    """Join the process group (idempotent) and return this rank's device.

    Arguments default to the `DYNO_COORDINATOR` ("host:port") /
    `DYNO_NUM_PROCESSES` / `DYNO_PROCESS_ID` environment variables, which
    give a `tcp://` rendezvous; where those are unset, torchrun's
    `MASTER_ADDR` / `WORLD_SIZE` / `RANK` give an `env://` one (the
    counterpart of JAX's autodetection on managed pods).  With neither,
    nothing is joined: a single-process run.  The backend follows the
    device (CUDA unless `device` says otherwise): NCCL on CUDA, gloo on
    the CPU; a CUDA rank takes card `LOCAL_RANK` (or its process id)
    modulo the cards present."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return _rank_device(dev)
    coordinator_address = coordinator_address or os.environ.get("DYNO_COORDINATOR")
    if num_processes is None and "DYNO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DYNO_NUM_PROCESSES"])
    if process_id is None and "DYNO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DYNO_PROCESS_ID"])
    if coordinator_address is not None:
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes or 1,
                    rank=process_id or 0)
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init = dict(init_method="env://")
    else:
        return dev      # single-process run, nothing to join
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", init.get("rank", os.environ.get("RANK", 0))))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **init)
    return _rank_device(dev)


def _rank_device(dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        return dev
    backend = dist.get_backend() if dist.is_initialized() else "nccl"
    if backend != "nccl":
        raise RuntimeError(f"a CUDA run needs an NCCL process group, not {backend}")
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh(tracks: int = 1) -> DeviceMesh:
    """(frames x tracks) mesh over all ranks: rank r = f * tracks + t, so
    process blocks stack onto FRAMES and the tracks axis groups
    consecutive ranks, which `LOCAL_WORLD_SIZE` (torchrun; 1 otherwise)
    must keep inside one host."""
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if tracks < 1 or n_local % tracks != 0:
        raise ValueError(f"tracks axis {tracks} must divide the {n_local} ranks of a host")
    return make_mesh(tracks=tracks)


def local_frame_range(mesh: DeviceMesh, n_frames: int) -> tuple:
    """[start, stop) of the frame rows THIS rank owns under the frame
    split: the block a host must load and feed."""
    fi, _, F, _ = mesh_coords(mesh)
    if n_frames % F:
        raise ValueError(f"{n_frames} frames do not split over the {F}-way frame axis")
    s = n_frames // F
    return fi * s, (fi + 1) * s


def feed_measurement_map(m_local: MeasurementMap, mesh: DeviceMesh) -> ShardedMap:
    """Host-local data feeding: `m_local` holds only this rank's
    `local_frame_range` rows of every leaf (all track slots).  Returns the
    rank's blocks in the solve's layout (`map_compute_shardings`): what
    that layout replicates over frames is assembled by ONE all_gather over
    the frames group (every such leaf packed into one float64 buffer,
    exact for the map's float32, int32 and bool fields); the rest keeps
    its own rows.  The track axis is then split locally."""
    _, ti, F, T = mesh_coords(mesh)
    feed = _leaves(m_local, map_shardings(mesh))
    comp = _leaves(m_local, map_compute_shardings(mesh))
    leaves = [x for x, _ in feed]
    gather = [isinstance(pf[0], Shard) and not isinstance(pc[0], Shard) for (_, pf), (_, pc) in zip(feed, comp)]
    rows = m_local.frame_valid.shape[0]
    if F > 1:
        packed = torch.cat([x.reshape(rows, -1).to(torch.float64) for x, g in zip(leaves, gather) if g], dim=1)
        full = all_gather_rows(packed, mesh.get_group(FRAME_AXIS), F)
        off = 0
        for i, x in enumerate(leaves):
            if gather[i]:
                n = x[0].numel()
                leaves[i] = full[:, off:off + n].reshape(F * rows, *x.shape[1:]).to(x.dtype)
                off += n

    def split_tracks(x, p):
        if isinstance(p[1], Shard):
            b = x.shape[p[1].dim] // T
            x = x.narrow(p[1].dim, ti * b, b)
        return x

    it = iter(leaves)
    local = tree_map2(lambda _, p: split_tracks(next(it), p), m_local, map_compute_shardings(mesh))
    return ShardedMap(local, "compute", F * rows)


def _leaves(tree, spec) -> list:
    """(leaf, placements) pairs in tree order."""
    out = []
    tree_map2(lambda x, p: out.append((x, p)) or x, tree, spec)
    return out
