"""K7-K9 — one Levenberg-Marquardt iteration of the direct-Schur window
solve (WorldMotion, updater 0) on the device.

Replaces no Pallas kernel: the three are the device-side form of the JAX
package's fused window LM, one XLA `lax.while_loop`
(`dynosam_tpu/backend/schur.py:1463`; its build `:611`, its step `:1072`),
which the port replayed as ~1,090 small ATen kernels an iteration.  CUDA
source: `csrc/window.cu` (the contract is stated there).

- K7 `build(t, params)`: the normal system (`backend/schur.py:
  build_normal_system` with `sqrt_weights`) at the state's values and
  residuals, written into the state's `NormalSystem` tensors;
- K8 `step(t, params)`: the damped Schur reduction (`schur.schur_reduce`),
  returning (Hred, bred, back); `back` is empty: the reduction's
  intermediates stay on chip, and K9 needs none of them;
- K9 `update(t, params, sol, info)`: the back-substitution,
  retraction, trial residuals and robust error and the LM decisions
  (`schur.schur_back` and `schur._lm_tail`), written into the state;
  returns the step it took ({X, P, sp, dp}, `schur_back`'s dict, as views
  of its step buffer); `head(t, params)` runs it at a zero step, the LM
  head (`schur._lm_head`).

`t` is the dict of named tensors `POINTERS` lists (the state's values,
residuals, window, masks, anchor, normal system and LM scalars), `params`
the settings `PARAMS` lists.  The wrappers, which run the plain versions on
the CPU, are `backend/schur.py:window_build`, `window_step` and
`window_update`.  These bindings take contiguous float32 CUDA tensors of
one device and raise on anything else, and on a window the kernels do not
take (`check`); there is no fallback.  Each call counts one launch of its
kernel (K7 is one kernel, K8 two and K9 two, back to back).

Bound on the card: latency.  An iteration of a KITTI window (W 10, 1,024
static points and tracks, 8 objects) needs ~0.1 GFLOP and ~20 MB of
traffic; every sum runs in a fixed order, with no float atomics (each
kernel's last block is found by an integer ticket in the state,
`tickets`), so a launch repeats bit for bit.
"""

from __future__ import annotations

import ctypes
import types

import torch

from . import build as _build

BUILD = types.SimpleNamespace(launches=0)    # calls of `build` that launched K7
STEP = types.SimpleNamespace(launches=0)     # ... of `step` (K8)
UPDATE = types.SimpleNamespace(launches=0)   # ... of `update` (K9)

MAX_W, MAX_NS, MAX_ND, MAX_O = 16, 1024, 1024, 8
# the state's integer counters (zero between launches): K8's and K9's
# tickets for their last block, then per frame the objects its tracks carry
TICKETS = 2 + MAX_W

# the pointer table of `csrc/window.cu` (enum Ptr), in its order
POINTERS = (
    "XR", "Xt", "HR", "Ht", "sp", "dp",
    "r_anchor", "r_odo", "r_static", "r_dyn", "r_tern", "r_smooth",
    "static_xyz", "dyn_xyz", "dyn_obj", "XiR", "Xit",
    "static_obs", "dyn_obs", "ternary", "smoothing", "odometry",
    "anchor_R", "anchor_t", "prior_L",
    "Hcc", "Dmm", "Omm1", "Omm2", "b_cam", "b_mot", "Hll_s", "Us", "b_sp", "Rc", "b_dp", "onehot", "chain_c",
    "chain_T", "st_s", "st_R", "st_G", "st_phi",
    "err", "lam", "lam_min", "done", "accept", "flags", "err_init", "tickets",
    "Hred", "bred", "sol", "info", "trial", "partials", "part", "obj", "act_list", "act_count", "keep", "step",
)
# the float settings of `csrc/window.cu` (enum Param), in its order
PARAMS = ("sig_s", "sig_d", "sig_t", "sig_d2", "sig_t2", "prior_sigma", "k_s", "k_d", "half_k2_s", "half_k2_d",
          *(f"odo_sig{i}" for i in range(6)), *(f"smooth_sig{i}" for i in range(6)),
          "floor", "tiny", "rel", "lambda_factor", "max_lambda", "rel_tol", "abs_tol", "initial_lambda",
          "min_lambda")

_BOOL = ("static_obs", "dyn_obs", "ternary", "smoothing", "odometry", "done", "accept", "flags")
_INT = ("dyn_obj", "obj", "info", "act_list", "act_count", "tickets")
_INPUTS = POINTERS[:POINTERS.index("Hred")]


def shapes(W: int, NS: int, ND: int, O: int) -> dict:
    """The shape of every tensor of the state (`_INPUTS`) for a window of W
    frames, NS static points, ND tracks and O objects."""
    return {
        "XR": (W, 3, 3), "Xt": (W, 3), "HR": (W, O, 3, 3), "Ht": (W, O, 3), "sp": (NS, 3), "dp": (W, ND, 3),
        "r_anchor": (1, 6), "r_odo": (W - 1, 6), "r_static": (W, NS, 3), "r_dyn": (W, ND, 3),
        "r_tern": (W - 1, ND, 3), "r_smooth": (W - 1, O, 6),
        "static_xyz": (W, NS, 3), "dyn_xyz": (W, ND, 3), "dyn_obj": (W, ND), "XiR": (W, 3, 3), "Xit": (W, 3),
        "static_obs": (W, NS), "dyn_obs": (W, ND), "ternary": (W, ND), "smoothing": (W, O), "odometry": (W,),
        "anchor_R": (3, 3), "anchor_t": (3,), "prior_L": (6, 6),
        "Hcc": (W, 6, W, 6), "Dmm": (W, O, 6, 6), "Omm1": (W - 1, O, 6, 6), "Omm2": (max(W - 2, 0), O, 6, 6),
        "b_cam": (W, 6), "b_mot": (W, O, 6), "Hll_s": (NS, 3, 3), "Us": (W, NS, 6, 3), "b_sp": (NS, 3),
        "Rc": (W, ND, 3, 6), "b_dp": (W, ND, 3), "onehot": (W, ND, O), "chain_c": (W, ND), "chain_T": (W, ND),
        "st_s": (W, ND), "st_R": (W, ND, 3, 3), "st_G": (W, ND, 3, 6), "st_phi": (W, ND, 3),
        "err": (), "lam": (), "lam_min": (), "done": (), "accept": (), "flags": (2, 1), "err_init": (),
        "tickets": (TICKETS,),
    }


def dims_of(t: dict) -> tuple:
    """(W, NS, ND, O) of a tensor dict."""
    W, O = t["HR"].shape[:2]
    return W, t["sp"].shape[0], t["dp"].shape[1], O


def check(t: dict) -> tuple:
    """Raise unless `t` is a window the kernels take: every tensor of
    `_INPUTS` present (`prior_L` may be None) with its shape, dtype (float32;
    bool masks and flags; int32 object ids and tickets) and a contiguous layout, on one
    device, 2 <= W <= 16, NS and ND <= 1024 and O <= 8.  Returns (W, NS,
    ND, O).  Runs on any device (the kernels need CUDA)."""
    missing = [k for k in _INPUTS if k not in t or (t[k] is None and k != "prior_L")]
    if missing:
        raise ValueError(f"window kernels: missing tensors {missing}")
    W, NS, ND, O = dims_of(t)
    if not (2 <= W <= MAX_W and 1 <= NS <= MAX_NS and 1 <= ND <= MAX_ND and 1 <= O <= MAX_O):
        raise ValueError(f"window kernels take 2 <= W <= {MAX_W} frames, at most {MAX_NS} static points, "
                         f"{MAX_ND} tracks and {MAX_O} objects (got W {W}, NS {NS}, ND {ND}, O {O})")
    want = shapes(W, NS, ND, O)
    dev = t["XR"].device
    for k in _INPUTS:
        x = t[k]
        if x is None:
            continue
        dtype = torch.bool if k in _BOOL else torch.int32 if k in _INT else torch.float32
        if tuple(x.shape) != want[k] or x.dtype != dtype:
            raise ValueError(f"window kernels: {k} must be {dtype} of shape {want[k]} "
                             f"(got {x.dtype} {tuple(x.shape)})")
        if not x.is_contiguous():
            raise ValueError(f"window kernels: {k} must be contiguous")
        if x.device != dev:
            raise ValueError(f"window kernels: {k} lies on {x.device}, not {dev}")
    return W, NS, ND, O


def launch_shape(W: int, NS: int, ND: int, O: int) -> dict:
    """Blocks and threads of each kernel for a window of this size (K8's
    segment pass with `seg_smem` bytes of dynamic shared memory and
    `chains_at_once` chains solved at once), and
    the sizes of the scratch buffers: the trial's floats, the blocks of
    error partials, the floats of the segment partials and of KEEP (a
    record a (frame, track), written only for a track with an object), and
    the ints of the segments' lists of those tracks and of their counts."""
    out = (ctypes.c_int * 24)()
    _build.check(_build.function("dyno_window_launch_shape")((ctypes.c_int * 4)(W, NS, ND, O), out),
                 "window launch shape")
    names = ("build", "seg", "assemble", "trial", "commit")
    shape = {n: {"blocks": out[2 * i], "threads": out[2 * i + 1]} for i, n in enumerate(names)}
    shape.update(trial_floats=out[10], partial_blocks=out[11], part=out[12], keep=out[13], seg_smem=out[14],
                 chains_at_once=out[15], assemble_smem=out[16], act_list=out[17], act_count=out[18])
    return shape


def _launch(name: str, t: dict, params: dict, counter) -> None:
    if t["XR"].device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors; on the CPU backend/schur.py's wrapper runs the plain version")
    dims = check(t)
    for k in POINTERS[len(_INPUTS):]:
        x = t.get(k)
        if x is not None and (not x.is_contiguous() or x.device != t["XR"].device):
            raise ValueError(f"window kernels: scratch {k} must be contiguous on {t['XR'].device}")
    ptrs = (ctypes.c_longlong * len(POINTERS))(*(0 if t.get(k) is None else t[k].data_ptr() for k in POINTERS))
    vals = (ctypes.c_float * len(PARAMS))(*(float(params[k]) for k in PARAMS))
    code = _build.function(name)(ptrs, (ctypes.c_int * 4)(*dims), vals, _build.stream_handle(t["XR"]))
    _build.check(code, name)
    counter.launches += 1


def build(t: dict, params: dict) -> None:
    """Launch K7: write the normal system into t's `NormalSystem` tensors."""
    _launch("dyno_window_build", t, params, BUILD)


def step(t: dict, params: dict):
    """Launch K8: returns (Hred (n, n), bred (n,), back), `back` empty."""
    W, NS, ND, O = dims_of(t)
    n = 6 * W * (1 + O)
    dev = t["XR"].device
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    shape = launch_shape(W, NS, ND, O)
    Hred = torch.empty((n, n), **f32)
    bred = torch.empty((n,), **f32)
    scratch = {"part": torch.empty((shape["part"],), **f32), "obj": torch.empty((W, ND), **i32),
               "act_list": torch.empty((shape["act_list"],), **i32), "act_count": torch.empty((shape["act_count"],), **i32),
               "keep": torch.empty((shape["keep"],), **f32)}
    _launch("dyno_window_step", {**t, **scratch, "Hred": Hred, "bred": bred}, params, STEP)
    return Hred, bred, {}


def _trial_scratch(t: dict) -> dict:
    W, NS, ND, O = dims_of(t)
    shape = launch_shape(W, NS, ND, O)
    dev = t["XR"].device
    return {"trial": torch.empty((shape["trial_floats"],), dtype=torch.float32, device=dev),
            "partials": torch.empty((shape["partial_blocks"], 6), dtype=torch.float32, device=dev)}


def head(t: dict, params: dict) -> None:
    """Launch K9 at a zero step: the LM head (`schur._lm_head`), the
    residuals and error at t's values, the initial error and lambda,
    written into `t`.  Counts one launch of K9."""
    _launch("dyno_window_head", {**t, **_trial_scratch(t)}, params, UPDATE)


def update(t: dict, params: dict, sol: torch.Tensor, info: torch.Tensor) -> dict:
    """Launch K9 on the solution `sol` (n,) and cuSOLVER's `info` (int32):
    write the accepted values, residuals and the LM scalars into `t`.
    Returns the step {X (W, 6), P (W, O, 6), sp (NS, 3), dp (W, ND, 3)}
    (NaN throughout after a failed factorisation)."""
    W, NS, ND, O = dims_of(t)
    nc, n = 6 * W, 6 * W * (1 + O)
    if sol.shape != (n,) or sol.dtype != torch.float32 or info.dtype != torch.int32 or info.numel() != 1:
        raise ValueError(f"window update: sol must be float32 ({n},) and info one int32")
    st = torch.empty((n + 3 * NS + 3 * W * ND,), dtype=torch.float32, device=t["XR"].device)
    _launch("dyno_window_update", {**t, **_trial_scratch(t), "sol": sol.contiguous(), "info": info.reshape(()),
                                   "step": st}, params, UPDATE)
    return {"X": st[:nc].view(W, 6), "P": st[nc:n].view(W, O, 6), "sp": st[n:n + 3 * NS].view(NS, 3),
            "dp": st[n + 3 * NS:].view(W, ND, 3)}
