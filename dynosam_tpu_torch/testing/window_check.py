"""K7-K9 (`csrc/window.cu`, the WorldMotion window LM iteration) against
their plain versions on one window, on the card: what `chip_smoke.py` and
`tests/test_torch_cuda.py` run.

For a window solve's inputs (`lm_optimize_schur`'s values, window, masks,
settings, anchor and fixed-lag prior), `hold_window` builds the solve's
state as the graphed solve does (`schur._WindowLM` on the kernel route,
after its head) and holds each kernel against its plain version
(`schur.window_build_plain`, `window_step_plain`, `window_update_plain`)
on that state: K7 from the head's residuals, K8 on the plain version's
system (its outputs: the damped reduced system Hred and bred; the
reduction's intermediates stay on chip), K9 on the plain version's reduced
solution (its outputs: the state it writes and the step it took, the
camera, motion, static-point and dynamic-point increments, against
`schur_back`'s).  Each entry of each
output is held to its plain version on the card within K_MARGIN times the
plain version's own float32 spread on its block (`TILES`: a 6x6 block of
Hcc or of the reduced system, a point's 3-vector, ...) -- the block's
largest difference from the same plain version on the CPU and on the card
with every float input moved by PERTURB (one or two ulps, N_PERTURBED
draws) -- and at least ULP_FLOOR of the block's largest entry; the accept
and done decisions must agree.  Each
kernel is launched twice on the same state and must repeat bit for bit.
K9 at a zero step, the LM head (`schur.window_head`), is held the same way
on the state before the head.  `hold_solve` then solves the window graphed
through K7-K9 and with the
ATen pieces (`overrides={}`) on the same inputs: the final errors within
SOLVE_ERR_RTOL, the camera translations within SOLVE_X_TOL_M and the
iterations within SOLVE_ITER_TOL, the float32 spread of a window solve
(`tests/test_torch_schur.py`'s module docstring, `tests/f32_spread.py`).

Runs on the CPU too, for a rehearsal, with `kernels` replacing the three
wrappers (the CPU has no kernel).
"""

from __future__ import annotations

import time

import torch

from ..backend import schur
from ..utils.graphs import tree_copy_

K_MARGIN = 4.0
ULP_FLOOR = 16 * 2.0 ** -23
PERTURB = 2.0 ** -22
N_PERTURBED = 2
SOLVE_ERR_RTOL, SOLVE_X_TOL_M, SOLVE_ITER_TOL = 3e-2, 2e-3, 2
PIECES = ("build", "step", "update")
HELD = ("head", "build", "step", "update")      # the head is K9 at a zero step
KERNEL_ID = {"head": 9, "build": 7, "step": 8, "update": 9}
# Each output is held block by block, each block on its own scale, so that
# a large block (the anchor's in Hcc and Hred) sets no other's tolerance:
# tile sizes per dim counted from the last, 0 for the whole dim, 1 (the
# dims not given) for each index alone.  Matrices over the stacked camera
# and motion variables in 6x6 blocks, their vectors and columns in
# 6-vectors; a point's or track's 3x3, 3x6, 6x3 or 6x6 matrix; a
# per-(frame, track) scalar alone; any other field's last dim (a point, a
# track's 3-vector, a residual) whole.
TILES = {"Hcc": (0, 1, 0), "Hred": (6, 6), "bred": (6,),
         **dict.fromkeys(("Dmm", "Omm1", "Omm2", "Hll_s", "Us", "Rc", "st_R", "st_G", "X.R", "H.R"), (0, 0)),
         **dict.fromkeys(("chain_c", "chain_T", "st_s"), ())}
STEP = ("X", "P", "sp", "dp")        # K9's step, `schur_back`'s dict, held as step.X, ...

# FLOPs of the plain formulas a kernel evaluates, counted from
# `csrc/window.cu` per unit of work; the bound takes the work this window's
# data needs (observed points, tracks with an active motion factor)
FLOP_BUILD_OBS = 330        # weight, Jacobian and its 6x6 + 6 outer products (frame block)
FLOP_BUILD_STATIC = 170     # Us, Hll_s and b_sp terms of one (frame, point)
FLOP_BUILD_DYN = 260        # Rc, b_dp, chain_c and the motion factor of one (frame, track)
FLOP_BUILD_POSE = 9000      # two right-Jacobian inverses, adjoint and Gram blocks of one pose pair
FLOP_STEP_STATIC_COL = 45   # damped adjugate inverse's share and one column of Hll^-1 [Us | b_sp]
FLOP_STEP_CHAIN_COL = 45    # forward and backward substitution of one column at one frame
FLOP_STEP_TERM = 6          # one 3-term product into a reduced-system entry
FLOP_UPDATE_STATIC = 80     # residual and Huber loss of one (frame, point)
FLOP_UPDATE_TRACK = 400     # a (frame, track)'s blocks, right side, chain step and point step
FLOP_UPDATE_RETRACT = 250   # one SE(3) exponential and composition


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, tuple):
        items = [_to(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _perturbed(tree, seed: int):
    """`tree` with every float tensor multiplied by 1 +- PERTURB, the sign
    drawn per element from `seed`."""
    def move(x):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        g = torch.Generator(device=x.device).manual_seed(seed)
        sign = torch.randint(0, 2, x.shape, generator=g, device=x.device).to(x.dtype) * 2 - 1
        return x * (1 + sign * PERTURB)

    return torch.utils._pytree.tree_map(move, tree)


def _state_out(s: dict) -> dict:
    v = s["vals"]
    out = {"X.R": v["X"].R, "X.t": v["X"].t, "H.R": v["H"].R, "H.t": v["H"].t, "sp": v["sp"], "dp": v["dp"]}
    out.update({f"res{i}": r for i, r in enumerate(s["res"])})
    out.update({k: s[k] for k in ("err", "err_init", "lam", "lam_min", "done", "accept", "flags")})
    return out


def simulator_window(device) -> tuple:
    """`lm_optimize_schur`'s arguments for the window-10 simulator scenario
    (`testing/simulator.py`, 2 objects whose tracks carry active motion
    factors) on `device`, its values moved off the initial ones (X by 1e-2
    in the tangent, H drawn at 5e-2, dp by 2e-2 m, from a CPU generator
    seeded 3), 30 LM iterations allowed."""
    from ..backend import formulation as fm
    from ..backend import map as bmap
    from ..backend.solver import LMConfig
    from ..core.lie import se3_exp, se3_retract
    from ..frontend.frontend import to_device
    from ..utils.config import BackendConfig
    from .simulator import Scenario, ScenarioConfig

    scfg = ScenarioConfig(n_frames=10)
    m = bmap.MeasurementMap.create(10, scfg.ns, scfg.nd, scfg.no, device=device)
    for k, p in enumerate(Scenario(scfg).frontend_outputs()):
        bmap.update_map(m, to_device(p, device), k)
    cfg = BackendConfig()
    w = bmap.slice_window(m, 0, 10)
    masks = fm.build_masks(w, cfg)
    v0 = fm.init_values(w, masks, cfg)
    g = torch.Generator().manual_seed(3)
    W, O = masks.motion_active.shape
    moved = dict(v0)
    moved["X"] = se3_retract(v0["X"], (0.01 * torch.randn((W, 6), generator=g)).to(device))
    moved["H"] = se3_exp((0.05 * torch.randn((W, O, 6), generator=g)).to(device))
    moved["dp"] = v0["dp"] + (0.02 * torch.randn(v0["dp"].shape, generator=g)).to(device)
    return moved, w, masks, cfg, LMConfig(max_iterations=30), w.X_init[0]


def window_lm(args: tuple, kw: dict) -> schur._WindowLM:
    """An uncaptured window LM of `lm_optimize_schur(*args, **kw)`'s
    window on the kernel route, its state after the head."""
    values, w, masks, cfg, lm_cfg, anchor = args[:6]
    formulation = kw.get("formulation", args[6] if len(args) > 6 else 0)
    if formulation != 0:
        raise ValueError("K7-K9 carry the WorldMotion solve (formulation 0)")
    lm = schur._WindowLM(values, w, masks, cfg, lm_cfg, anchor, 0, kw.get("anchor_prior_L"))
    if not lm.kernels:
        raise ValueError("a piece of the window LM is replaced: the solve is not on the kernel route")
    lm.head()
    return lm


class Pieces:
    """Run one piece (kernel or plain) of one window LM on a fixed state:
    the state is restored before each run and the outputs are copied out."""

    def __init__(self, lm: schur._WindowLM, kernels=None):
        self.lm = lm
        self.kernels = kernels or {"head": schur.window_head, "build": schur.window_build,
                                   "step": schur.window_step, "update": schur.window_update}
        # the system the plain version builds at the state, then K9's inputs:
        # the plain reduction and factorisation there
        self.s0 = schur._contiguous(lm.s)
        self.run("build", False)
        self.s0 = schur._contiguous(lm.s)
        Hred, bred, back = schur.window_step_plain(lm.args)
        L, info = torch.linalg.cholesky_ex(Hred)
        sol = torch.cholesky_solve(bred[:, None], L)[:, 0]
        self.fixed = schur._contiguous((sol, info, back))

    def run(self, piece: str, kernel: bool, s0=None, fixed=None, lm=None) -> dict:
        lm = lm or self.lm
        tree_copy_(lm.s, self.s0 if s0 is None else s0)
        a = lm.args
        if piece == "head":
            (self.kernels["head"] if kernel else schur.window_head_plain)(a)
            out = _state_out(lm.s)
        elif piece == "build":
            (self.kernels["build"] if kernel else schur.window_build_plain)(a)
            out = dict(lm.s["sys"]._asdict())
        elif piece == "step":
            Hred, bred, _ = (self.kernels["step"] if kernel else schur.window_step_plain)(a)
            out = dict(Hred=Hred, bred=bred)
        else:
            sol, info, back = self.fixed if fixed is None else fixed
            d = (self.kernels["update"] if kernel else schur.window_update_plain)(a, sol, info, back)
            out = dict(_state_out(lm.s), **{f"step.{k}": d[k] for k in STEP})
        return schur._contiguous(out)

    def spread_runs(self, piece: str) -> list:
        """The plain version on the CPU and on the card at perturbed inputs."""
        lm = self.lm
        a = lm.args
        cpu = torch.device("cpu")
        lm_cpu = schur._WindowLM.__new__(schur._WindowLM)
        s_cpu = _to(self.s0, cpu)
        lm_cpu.s, lm_cpu.kernels = s_cpu, True
        lm_cpu.args = schur.WindowArgs(s_cpu, _to(a.w, cpu), _to(a.masks, cpu), _to(a.anchor, cpu),
                                       _to(a.prior, cpu), a.cfg, a.lm_cfg)
        runs = [_to(self.run(piece, False, s_cpu, _to(self.fixed, cpu), lm_cpu), self.s0["err"].device)]
        for i in range(N_PERTURBED):
            s_p = _perturbed(self.s0, 1 + i)
            fixed_p = (_perturbed(self.fixed[0], 11 + i), self.fixed[1], _perturbed(self.fixed[2], 21 + i))
            runs.append(self.run(piece, False, s_p, fixed_p))
        return runs


def _block_max(x: torch.Tensor, tiles: tuple) -> torch.Tensor:
    """|x| (its finite entries; 0 elsewhere) maxed over each block of
    `tiles` (`TILES`), broadcast back to x's shape."""
    a = torch.where(torch.isfinite(x), x.abs(), torch.zeros((), dtype=x.dtype, device=x.device))
    if a.dim() == 0 or a.numel() == 0:
        return a
    for i, t in enumerate(tiles):
        d = a.dim() - 1 - i
        n = a.shape[d]
        t = n if t == 0 else t
        if t == 1:
            continue
        m = -(-n // t) * t
        a = a.movedim(d, -1)
        a = torch.nn.functional.pad(a, (0, m - n))
        a = a.reshape(*a.shape[:-1], m // t, t).amax(-1, keepdim=True).expand(*a.shape[:-1], m // t, t)
        a = a.reshape(*a.shape[:-2], m)[..., :n].movedim(-1, d)
    return a


def _field_check(name, kern, plain, others):
    """(largest error, the error and tolerance of the entry farthest out of
    its tolerance, ok, exact) of one output field,
    each entry held on its block's scale (`TILES`): K_MARGIN times the
    block's largest spread, at least ULP_FLOOR of the block's largest
    entry.  Non-finite entries of the plain version must be the kernel's
    too."""
    if not plain.is_floating_point():
        eq = bool(torch.equal(kern, plain))
        return 0.0 if eq else 1.0, 0.0 if eq else 1.0, 0.0, eq, True
    if plain.numel() == 0:
        return 0.0, 0.0, 0.0, kern.numel() == 0, False
    tiles = TILES.get(name, (0,))
    zero = torch.zeros((), dtype=plain.dtype, device=plain.device)
    fin = torch.isfinite(plain)
    diffs = [torch.where(fin & torch.isfinite(o), (plain - o).abs(), zero) for o in others if o.numel()]
    spread = torch.stack(diffs).amax(0) if diffs else torch.zeros_like(plain)
    tol = torch.maximum(K_MARGIN * _block_max(spread, tiles), ULP_FLOOR * _block_max(plain, tiles))
    diff = (kern - plain).abs()
    within = torch.where(fin, diff <= tol, torch.ones((), dtype=torch.bool, device=plain.device))
    same_nonfinite = torch.equal(torch.where(fin, zero, kern).nan_to_num(nan=0.5),
                                 torch.where(fin, zero, plain).nan_to_num(nan=0.5))
    ok = bool(within.all()) and same_nonfinite
    diff = torch.where(fin, diff.nan_to_num(nan=float("inf")), zero)
    ratio = torch.where(diff > 0, diff / tol, zero)
    at = int(ratio.reshape(-1).argmax())
    return float(diff.max()), float(diff.reshape(-1)[at]), float(tol.reshape(-1)[at]), ok, False


def hold_pieces(pieces: Pieces, label: str, out=print, held=HELD) -> dict:
    """Each of K7-K9 (the pieces `held`) against its plain version, each
    entry of each output within its block's tolerance (`_field_check`),
    and twice on the same state, bit for bit.  Returns per piece the
    largest error, the entry nearest its tolerance (error, tolerance,
    field) and its share of it, and the fields out of tolerance; prints
    one line per piece."""
    report = {}
    for piece in held:
        kern = pieces.run(piece, True)
        again = pieces.run(piece, True)
        plain = pieces.run(piece, False)
        others = pieces.spread_runs(piece)
        same = all(torch.equal(kern[k].reshape(-1).view(torch.uint8),
                               again[k].reshape(-1).view(torch.uint8)) for k in kern)
        fields, worst, ratio = {}, (0.0, 0.0, ""), -1.0
        for k in plain:
            err, e_at, tol, ok, exact = _field_check(k, kern[k], plain[k], [o[k] for o in others])
            fields[k] = (err, tol, ok)
            r = e_at / tol if tol > 0 else (float("inf") if e_at > 0 else 0.0)
            if not exact and r > ratio:
                worst, ratio = (e_at, tol, k), r
        bad = [k for k, (_, _, ok) in fields.items() if not ok]
        largest = max(fields, key=lambda k: fields[k][0])
        report[piece] = dict(max_abs_err=fields[largest][0], worst=worst, ratio=ratio, bad=bad, repeat=same,
                             fields=fields)
        out(f"{label}: K{KERNEL_ID[piece]} window_{piece} against its plain version: "
            f"{'agrees' if not bad else 'DISAGREES on ' + str(bad)} (largest |kernel - plain| "
            f"{fields[largest][0]:.3g}, in {largest}; the entry nearest its tolerance, in {worst[2]}: "
            f"{worst[0]:.3g} within {worst[1]:.3g}, {ratio:.3g} of it; tolerance {K_MARGIN:g}x the plain version's "
            f"spread on the entry's block, at least {ULP_FLOOR:.3g} of the block's scale); twice on one state "
            f"{'bit for bit' if same else 'DIFFERENT'}")
    return report


def hold_failed_step(pieces: Pieces, label: str, out=print) -> bool:
    """K9 and its plain version after a failed factorisation (`info` 1): the
    step NaN throughout in both, rejected, the values, residuals and error
    kept, lambda raised and its floor ratcheted, the state in both bit for
    bit."""
    sol, _, back = pieces.fixed
    bad = (sol, torch.ones_like(pieces.fixed[1]), back)
    kern = pieces.run("update", True, fixed=bad)
    plain = pieces.run("update", False, fixed=bad)
    s0 = _state_out(pieces.s0)
    kept = all(torch.equal(kern[k], s0[k]) for k in s0 if k not in ("lam", "lam_min", "done", "accept", "flags"))
    same = all(torch.equal(kern[k], plain[k]) for k in s0)
    nan = all(bool(torch.isnan(r[f"step.{k}"]).all()) for r in (kern, plain) for k in STEP)
    ok = kept and same and nan and not bool(kern["accept"]) and float(kern["lam"]) > float(s0["lam"])
    out(f"{label}: K9 after a failed factorisation: step {'NaN throughout' if nan else 'NOT all NaN'} and "
        f"{'rejected, state kept' if kept else 'NOT rejected'}, lambda {float(s0['lam']):.3g} -> "
        f"{float(kern['lam']):.3g}, lowest lambda {float(kern['lam_min']):.3g}; the state "
        f"{'equals' if same else 'DIFFERS from'} the plain version's bit for bit")
    return ok


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def work(pieces: Pieces) -> dict:
    """Per piece (FLOPs, bytes) this window's data needs, whatever
    implements it: bytes each input read once and each output written once
    (K7: the state and window in, the system out; K8: the system in, the
    reduced system out; K9: the system, window, state and solution in, the
    trial state out), no intermediate between the kernels counted; the
    FLOPs of the plain formulas on the observations, points and tracks
    that take part (a chain solved only for a track with a motion factor
    or an object, as a motion-free track's is the identity)."""
    s = pieces.s0
    W, NS = s["sys"].Us.shape[:2]
    ND, O = s["sys"].Rc.shape[1], s["sys"].Dmm.shape[1]
    nc, nm = 6 * W, 6 * W * O
    n, C = nc + nm, 2 * nc + 1
    masks = pieces.lm.args.masks
    seen = masks.static_obs.sum(0).double()                     # frames that observe each static point
    n_static = int(seen.sum())
    n_dyn = int(masks.dyn_obs.sum())
    moving = s["sys"].st_s != 0
    with_obj = s["sys"].onehot.sum(-1) != 0
    n_act, n_obj = int(moving.sum()), int(with_obj.sum())
    n_chain = int((moving | with_obj).any(0).sum())
    n_pairs = (W - 1) * (1 + O) + 1

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    v, res, sysf = s["vals"], s["res"], s["sys"]
    state_bytes = nbytes(v["X"].R, v["X"].t, v["H"].R, v["H"].t, v["sp"], v["dp"], *res)
    sys_bytes = nbytes(*sysf)
    w = pieces.lm.args.w
    in_bytes = nbytes(w.static_xyz, w.dyn_xyz, w.dyn_obj, *masks)
    flop = {
        "build": (n_static + n_dyn) * FLOP_BUILD_OBS + W * NS * FLOP_BUILD_STATIC + W * ND * FLOP_BUILD_DYN
        + n_pairs * FLOP_BUILD_POSE,
        "step": int(((6 * seen + 1) * FLOP_STEP_STATIC_COL + 6 * seen * (6 * seen + 1) * FLOP_STEP_TERM).sum())
        + n_dyn * 42 * FLOP_STEP_TERM + n_chain * W * C * FLOP_STEP_CHAIN_COL
        + FLOP_STEP_TERM * (n_act * 6 * (nc + 1) + n_obj * (6 * 6 * W * 4 + 6)) + 3 * n * n,
        "update": W * NS * FLOP_UPDATE_STATIC + n_static * 36 + NS * 60 + W * ND * FLOP_UPDATE_TRACK
        + W * ND * 2 * FLOP_UPDATE_STATIC + (W * (1 + 2 * O) + ND * W) * FLOP_UPDATE_RETRACT,
    }
    moved = {
        "build": state_bytes + in_bytes + sys_bytes,
        "step": sys_bytes + 4 * (n * n + n),
        "update": state_bytes * 2 + sys_bytes + in_bytes + 4 * n,
    }
    return {p: (flop[p], moved[p]) for p in PIECES}


def time_pieces(pieces: Pieces, reps: int = 20) -> dict:
    """Per piece: the kernel's and the plain version's ms per call on the
    card (CUDA events over back-to-back calls on the restored state)."""
    lm = pieces.lm
    a = lm.args
    sol, info, back = pieces.fixed
    times = {}
    for piece in PIECES:
        tree_copy_(lm.s, pieces.s0)
        fns = {
            "build": (lambda: schur.window_build(a), lambda: schur.window_build_plain(a)),
            "step": (lambda: schur.window_step(a), lambda: schur.window_step_plain(a)),
            "update": (lambda: schur.window_update(a, sol, info, back),
                       lambda: schur.window_update_plain(a, sol, info, back)),
        }[piece]
        times[piece] = (_cuda_ms(fns[0], reps), _cuda_ms(fns[1], max(2, reps // 10)))
    tree_copy_(lm.s, pieces.s0)
    return times


def device_ms(pieces: Pieces, reps: int = 5) -> dict:
    """Per piece, the device time of its kernels a launch (`torch.profiler`'s
    CUDA activity over `reps` launches of each in one profiled run, the
    state restored before each launch, its copies left out; the launches
    counted in the trace)."""
    lm = pieces.lm
    a = lm.args
    sol, info, back = pieces.fixed
    calls = {"build": lambda: schur.window_build(a), "step": lambda: schur.window_step(a),
             "update": lambda: schur.window_update(a, sol, info, back)}
    for fn in calls.values():
        tree_copy_(lm.s, pieces.s0)
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            for fn in calls.values():
                tree_copy_(lm.s, pieces.s0)
                fn()
        torch.cuda.synchronize()
    # per piece its kernels' summed time over the launches the trace holds,
    # counted by each launch's last kernel
    last = {"build": "window_build_kernel", "step": "window_step_assemble", "update": "window_update_commit"}
    us, n = {p: 0.0 for p in PIECES}, {p: 0 for p in PIECES}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for p in PIECES:
                if f"window_{p}" in e.name:
                    us[p] += e.time_range.elapsed_us()
                    n[p] += last[p] in e.name
    tree_copy_(lm.s, pieces.s0)
    return {p: us[p] / max(n[p], 1) / 1e3 for p in PIECES}


def hold_solve(args: tuple, kw: dict, label: str, out=print) -> dict:
    """The window solved graphed through K7-K9 (`lm_optimize_schur`) and
    with the ATen pieces (`overrides={}`) on the same inputs."""
    got = schur.lm_optimize_schur(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = schur.lm_optimize_schur(*args, **kw)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = schur.lm_optimize_schur(*args, **kw, overrides={})
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    rel = abs(float(got.error) - float(ref.error)) / max(abs(float(ref.error)), 1e-30)
    dx = float((got.values["X"].t - ref.values["X"].t).abs().max())
    ok = (rel <= SOLVE_ERR_RTOL and dx <= SOLVE_X_TOL_M and abs(got.iterations - ref.iterations) <= SOLVE_ITER_TOL
          and float(got.error) < float(got.initial_error))
    out(f"{label}: window solve graphed through K7-K9 {k_ms:.2f} ms, {got.iterations} LM iterations, error "
        f"{float(got.initial_error):.6g} -> {float(got.error):.6g}; ATen pieces {p_ms:.2f} ms, {ref.iterations} LM "
        f"iterations, error {float(ref.error):.6g}; error rel {rel:.3g} (limit {SOLVE_ERR_RTOL}), camera "
        f"{dx:.3g} m (limit {SOLVE_X_TOL_M}): {'ok' if ok else 'FAIL'} (host clock, synchronised)")
    return dict(ok=ok, rel=rel, dx=dx, iterations=(got.iterations, ref.iterations), ms=(k_ms, p_ms))
