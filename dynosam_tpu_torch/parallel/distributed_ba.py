"""Distributed LM-PCG bundle adjustment on `torch.distributed` (port of
`dynosam_tpu/parallel/distributed_ba.py`).

The JAX package states this solve declaratively and lets GSPMD partition
it.  Torch has no such partitioner, so the decomposition is written out:

  * the factors are partitioned by frame block: block f owns the factors
    whose current (latest) frame lies in its S = W / F frames, and with a
    tracks axis each track block owns its static and dynamic slots while
    the pose-only factors stay on track block 0;
  * the values are replicated;
  * each rank evaluates its factors on the sub-window of its frames and
    the two before them (the pose triplets reach two back), with every
    factor it does not own weighted 0, and contributes its share of the
    cost, the gradient and each J^T W J v product;
  * one all_reduce combines each product, the gradient and the cost, so
    every CG vector and dot product is replicated and needs no collective;
  * the anchor prior is owned by rank 0 alone, so nothing counts twice.

The solve is `solver.lm_optimize` over the closed-form products of
`schur.world_{motion,pose}_normal_product`, both updaters, with
`LMConfig` defaulting from the backend config as in JAX.  As in JAX it is
given no analytic diagonal: damping and preconditioner are Hutchinson's
estimate of the rank-summed J^T W J (`solver.HUTCHINSON_PROBES` products
an LM iteration, one all_reduce each).  Every rank draws the same probes
from a generator seeded 0 on its own device.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..backend import formulation as fm
from ..backend.map import MeasurementMap, WindowData, slice_window
from ..backend.schur import world_motion_normal_product, world_pose_normal_product
from ..backend.solver import LMConfig, LMResult, lm_optimize, total_error
from ..utils.config import BackendConfig
from .mesh import all_reduce_packed, make_mesh, mesh_coords


def _ownership(fi: int, ti: int, T: int, lo: int, hi: int, start: int, ns: int, nd: int, no: int,
               n_fam: int, updater: int, device) -> list:
    """Per family of the sub-window [lo, hi), a 0/1 weight per factor row
    (and slot): 1 where this rank owns the factor."""
    frames = torch.arange(lo, hi, device=device)
    own_frame = (frames >= start).float()                        # factors of one frame
    own_pair = own_frame[1:]                                     # current frame lo + j + 1
    own_triple = own_frame[2:]                                   # current frame lo + j + 2
    pose_owner = float(ti == 0)

    def slots(n):
        b = n // T
        return (torch.arange(n, device=device) // b == ti).float()

    out = [torch.full((1,), float(fi == 0 and ti == 0), device=device),
           own_pair * pose_owner,
           own_frame[:, None] * slots(ns)[None],
           own_frame[:, None] * slots(nd)[None],
           own_pair[:, None] * slots(nd)[None]]
    if updater == 0:
        out.append(own_pair[:, None].expand(-1, no) * pose_owner)
    else:
        out.append(own_triple[:, None].expand(-1, no) * pose_owner)
        if n_fam > 6:
            out.append(own_pair[:, None].expand(-1, no) * pose_owner)
    return out


def distributed_optimize(m: MeasurementMap, window: int, cfg: BackendConfig, mesh: DeviceMesh | None = None,
                         updater: int = 0, lm_cfg: Optional[LMConfig] = None,
                         probes: Optional[Callable] = None) -> LMResult:
    """The LM-PCG solve of frames [0, window) of `m` (the whole map, held
    by every rank) over the mesh.  Returns the LMResult with the values
    whole (replicated) on every rank.  A one-rank mesh runs the same
    program.  `probes(it)` gives the Hutchinson probes of LM iteration
    `it` (the same on every rank) in place of the seeded generator's."""
    mesh = mesh or make_mesh()
    lm_cfg = lm_cfg or LMConfig(max_iterations=cfg.lm_max_iterations, cg_max_iterations=cfg.cg_max_iterations)
    p = rank_problem(m, window, cfg, mesh, updater)
    return lm_optimize(p.residual_fn, p.specs, p.values, lm_cfg, normal_fn=p.normal_fn, probes=probes,
                       error_fn=p.error_fn)


def rank_problem(m: MeasurementMap, window: int, cfg: BackendConfig, mesh: DeviceMesh, updater: int = 0):
    """This rank's share of the window problem: the replicated initial
    values and the LM-PCG callables over its owned factors, each summed
    over the group (`residual_fn` gives the rank's own residuals; the
    others return totals)."""
    fi, ti, F, T = mesh_coords(mesh)
    if window % F:
        raise ValueError(f"window {window} does not split over the {F}-way frame axis")
    w = slice_window(m, 0, window)
    masks = fm.build_masks(w, cfg)
    NS, ND = w.static_valid.shape[1], w.dyn_valid.shape[1]
    if NS % T or ND % T:
        raise ValueError(f"track pools ({NS}, {ND}) must divide {T}")
    O = w.motion_valid.shape[1]
    if updater == 0:
        values = fm.init_values(w, masks, cfg)
        spec, residuals, product = fm.world_motion_families(cfg), fm.world_motion_residuals, world_motion_normal_product
    else:
        values = fm.init_values_world_pose(w, masks, cfg)
        spec, residuals, product = fm.world_pose_families(cfg), fm.world_pose_residuals, world_pose_normal_product
    anchor = w.X_init[0]

    S = window // F
    start, hi = fi * S, (fi + 1) * S
    lo = max(0, start - 2)
    sub = slice(lo, hi)
    w_sub = WindowData(*(x[sub] for x in w[:-1]), start=w.start + lo)
    masks_sub = fm.WindowMasks(*(x[sub] for x in masks))
    dtype, dev = values["sp"].dtype, values["sp"].device
    own = [o.to(dtype) for o in _ownership(fi, ti, T, lo, hi, start, NS, ND, O, len(spec.robust), updater, dev)]

    def local(v: dict) -> dict:
        return {k: x if k == "sp" else x[sub] for k, x in v.items()}

    def embed(d: dict) -> dict:
        def put(k, x):
            if k == "sp":
                return x
            z = x.new_zeros((window, *x.shape[1:]))
            z[sub] = x
            return z
        return {k: put(k, x) for k, x in d.items()}

    def owned(parts: list) -> list:
        return [p * o.reshape(o.shape + (1,) * (p.dim() - o.dim())) for p, o in zip(parts, own)]

    def residual_fn(v):
        return owned(residuals(local(v), w_sub, masks_sub, cfg, anchor))

    def error_fn(res):
        err = total_error(res, spec.robust).reshape(1)
        torch.distributed.all_reduce(err)
        return err[0]

    def normal_fn(v, sqrt_w, res):
        JtJ_mv, g = product(local(v), owned(sqrt_w), res, w_sub, masks_sub, cfg, anchor)

        def mv(d):
            return all_reduce_packed(embed(JtJ_mv(local(d))))

        return mv, all_reduce_packed(embed(g))

    return SimpleNamespace(values=values, specs=spec.robust, residual_fn=residual_fn, error_fn=error_fn,
                           normal_fn=normal_fn)
