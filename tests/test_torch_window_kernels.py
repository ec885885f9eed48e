"""Kernels K7-K9 (the WorldMotion window LM iteration, `csrc/window.cu`;
wrappers `backend/schur.py:window_build`, `window_step`, `window_update`)
on the CPU, where their wrappers run the plain versions:

- the packed layout: the named tensors the kernels read and write
  (`schur.kernel_tensors`, `kernels/window.py:POINTERS`), read back as the
  kernels read them, fed to each plain version equal the eager pieces bit
  for bit -- K7's `build_normal_system` with `sqrt_weights`, K8's and
  K9's `schur_step` (its reduced system and step) and K9's LM decisions
  (`_lm_iteration`) -- on a window-10 simulator window with active motion
  factors, the same window with none (as KITTI's windows are), and with a
  fixed-lag anchor prior;
- the whole solve through the wrappers (`_WindowLM` on the kernel route)
  equals the eager loop (`_lm_loop`, what `lm_optimize_schur` runs on the
  CPU) bit for bit, in those three cases;
- the normal system of the packed layout's plain build against the JAX
  package's `build_normal_system` (1e-4 of each field's max-abs, as
  `tests/test_torch_schur.py` holds the port's);
- the card's checks (`testing/window_check.py`) with the plain versions in
  place of the kernels: zero error, bit-for-bit repeats;
- the kernels' argument checks refuse the windows they do not take, and
  the kernel route is taken only by WorldMotion with the module's own
  pieces.

The kernels themselves are held against these plain versions on the card
by `tests/test_torch_cuda.py` and `chip_smoke.py`
(`dynosam_tpu_torch/testing/window_check.py`).
"""

import jax
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import schur as jschur
from dynosam_tpu.ops.robust import robust_sqrt_weights
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu_torch.backend import schur
from dynosam_tpu_torch.backend.solver import LMConfig
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.kernels import window as kwin
from dynosam_tpu_torch.utils.graphs import tree_copy_

from test_torch_schur import _window, moved, rel_err, to_port

torch.set_num_threads(2)
leaves = torch.utils._pytree.tree_leaves
CASES = ("motion", "no_motion", "prior")
RES = ("r_anchor", "r_odo", "r_static", "r_dyn", "r_tern", "r_smooth")
SCALARS = ("err", "lam", "lam_min", "done", "accept", "flags")


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _prior():
    return torch.linalg.cholesky(torch.eye(6, dtype=torch.float64) * 1e8 + 1e7).float()


@pytest.fixture(scope="module")
def windows():
    """Per case: the JAX window and masks, the port's window, masks and
    config, and values moved off the initial ones (`moved`)."""
    jw, tw, jc, tc, jmk, tmk = _window(ScenarioConfig(n_frames=10))
    jv = moved(jfm.init_values(jw, jmk, jc), jmk)
    out = {}
    for case in CASES:
        masks = tmk
        if case == "no_motion":
            masks = tmk._replace(ternary=torch.zeros_like(tmk.ternary), smoothing=torch.zeros_like(tmk.smoothing),
                                 motion_active=torch.zeros_like(tmk.motion_active))
        out[case] = dict(jw=jw, jmk=jmk, jc=jc, jv=jv, w=tw, masks=masks, cfg=tc, values=to_port(jv),
                         prior=_prior() if case == "prior" else None)
    return out


def _lm(win, lm_cfg=LMConfig(max_iterations=30)) -> schur._WindowLM:
    lm = schur._WindowLM(win["values"], win["w"], win["masks"], win["cfg"], lm_cfg, win["w"].X_init[0], 0,
                         win["prior"])
    lm.head()
    return lm


def _unpack(t: dict, a: schur.WindowArgs) -> schur.WindowArgs:
    """The window LM the packed tensors `t` describe, read by name as the
    kernels read them."""
    s = dict(a.s)
    s["vals"] = {"X": SE3(t["XR"], t["Xt"]), "H": SE3(t["HR"], t["Ht"]), "sp": t["sp"], "dp": t["dp"]}
    s["res"] = [t[k] for k in RES]
    s["sys"] = schur.NormalSystem(**{f: t[f] for f in schur.NormalSystem._fields})
    s.update({k: t[k] for k in SCALARS})
    w = a.w._replace(static_xyz=t["static_xyz"], dyn_xyz=t["dyn_xyz"], dyn_obj=t["dyn_obj"],
                     X_init=SE3(t["XiR"], t["Xit"]))
    masks = a.masks._replace(**{k: t[k] for k in ("static_obs", "dyn_obs", "ternary", "smoothing", "odometry")})
    return schur.WindowArgs(s, w, masks, SE3(t["anchor_R"], t["anchor_t"]), t["prior_L"], a.cfg, a.lm_cfg)


def _packed(lm: schur._WindowLM) -> schur.WindowArgs:
    return _unpack(schur.kernel_tensors(lm.args), lm.args)


@pytest.fixture(scope="module")
def states(windows):
    """Per case: a window LM after its head and a copy of its state."""
    out = {}
    for case, win in windows.items():
        lm = _lm(win)
        out[case] = (lm, schur._contiguous(lm.s))
    return out


@pytest.mark.parametrize("case", CASES)
def test_plain_build_on_the_packed_layout_equals_build_normal_system(windows, states, case):
    lm, s0 = states[case]
    tree_copy_(lm.s, s0)
    a = lm.args
    ref = lm.p.build(a.s["vals"], a.s["res"])
    schur.window_build_plain(_packed(lm))
    assert _equal(lm.s["sys"], ref)


@pytest.mark.parametrize("case", CASES)
def test_plain_step_on_the_packed_layout_equals_schur_step(states, case):
    lm, s0 = states[case]
    tree_copy_(lm.s, s0)
    a = lm.args
    ref_delta, (ref_H, ref_b) = schur.schur_step(a.s["sys"], a.s["lam"], a.lm_cfg.diag_floor, 0, with_reduced=True)
    Hred, bred, back = schur.window_step_plain(_packed(lm))
    assert torch.equal(Hred, ref_H) and torch.equal(bred, ref_b)
    L, info = torch.linalg.cholesky_ex(Hred)
    delta = schur.schur_back(a.s["sys"], back, torch.cholesky_solve(bred[:, None], L)[:, 0], info, 0)
    assert _equal(delta, ref_delta)


@pytest.mark.parametrize("case", CASES)
def test_plain_update_on_the_packed_layout_equals_the_lm_iteration(states, case):
    """K9's plain version on the packed layout after K8's: the state
    `_lm_iteration` (without the rebuild) returns, accept and flags too."""
    lm, s0 = states[case]
    tree_copy_(lm.s, s0)
    ref = schur._lm_iteration(lm.s, False, lm.p)
    a = _packed(lm)
    Hred, bred, back = schur.window_step_plain(a)
    L, info = torch.linalg.cholesky_ex(Hred)
    schur.window_update_plain(a, torch.cholesky_solve(bred[:, None], L)[:, 0], info, back)
    for k in ("vals", "res", *SCALARS):
        assert _equal(lm.s[k], ref[k]), k


@pytest.mark.parametrize("case", CASES)
def test_window_lm_through_the_wrappers_equals_the_eager_loop(windows, case):
    """30 LM iterations allowed: each solve accepts and rejects steps."""
    win = windows[case]
    lm_cfg = LMConfig(max_iterations=30)
    args = (win["values"], win["w"], win["masks"], win["cfg"], lm_cfg, win["w"].X_init[0])
    lm = schur._WindowLM(*args, 0, win["prior"])
    assert lm.kernels
    got = lm.solve(win["values"], win["w"], win["masks"], win["w"].X_init[0], win["prior"])
    ref = schur.lm_optimize_schur(*args, anchor_prior_L=win["prior"])
    assert _equal(got.values, ref.values)
    for f in ("error", "initial_error", "lam"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.iterations, got.converged) == (ref.iterations, ref.converged)
    assert float(got.error) < float(got.initial_error)


@pytest.fixture(scope="module")
def jax_system(windows):
    """The JAX package's normal system of the motion window (jitted)."""
    win = windows["motion"]
    jw, jmk, jc = win["jw"], win["jmk"], win["jc"]

    @jax.jit
    def build(v):
        anchor = jw.X_init[0]
        res = jfm.world_motion_residuals(v, jw, jmk, jc, anchor)
        sw = [robust_sqrt_weights(r, s.k, s.kind) if s.kind != "none" else jax.numpy.ones(r.shape[:-1])
              for r, s in zip(res, jfm.world_motion_families(jc).robust)]
        return jschur.build_normal_system(v, sw, jw, jmk, jc, anchor, res)

    return build(win["jv"])


def test_packed_build_matches_jax_build_normal_system(windows, states, jax_system):
    lm, s0 = states["motion"]
    tree_copy_(lm.s, s0)
    schur.window_build_plain(_packed(lm))
    jsys = jax_system
    for f in schur.NormalSystem._fields:
        a, b = np.asarray(getattr(jsys, f)), getattr(lm.s["sys"], f)
        assert a.shape == tuple(b.shape), f
        if a.size and np.abs(a).max() > 0:
            assert rel_err(a, b) <= 1e-4, f


def _refused(t, change):
    t = dict(t)
    if change == "frames":
        for k, shape in kwin.shapes(17, 4, 4, 2).items():
            t[k] = torch.zeros(shape, dtype=t[k].dtype) if t.get(k) is not None else None
        t["prior_L"] = None
    elif change == "objects":
        t["HR"] = torch.zeros((10, 9, 3, 3))
    elif change == "points":
        t["sp"] = torch.zeros((1025, 3))
    elif change == "dtype":
        t["dp"] = t["dp"].double()
    elif change == "layout":
        t["Us"] = t["Us"].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif change == "missing":
        t.pop("st_G")
    elif change == "device":
        t["lam"] = t["lam"].to("meta")
    return t


@pytest.mark.parametrize("change", ["frames", "objects", "points", "dtype", "layout", "missing", "device"])
def test_the_kernels_refuse_windows_they_do_not_take(states, change):
    lm, s0 = states["motion"]
    a = lm.args._replace(s=s0)
    t = schur.kernel_tensors(a)
    v = s0["vals"]
    assert kwin.check(t) == (10, v["sp"].shape[0], v["dp"].shape[1], v["H"].t.shape[1])
    with pytest.raises(ValueError):
        kwin.check(_refused(t, change))
    with pytest.raises(ValueError, match="CUDA"):
        kwin.build(t, schur.kernel_params(a.cfg, a.lm_cfg))


def test_the_kernel_route_is_world_motion_with_the_modules_own_pieces(windows, monkeypatch):
    assert schur._kernel_route(0, torch.float32) and not schur._kernel_route(1, torch.float32)
    assert not schur._kernel_route(0, torch.float64)
    win = windows["motion"]
    real = schur.retract_tree
    monkeypatch.setattr(schur, "retract_tree", lambda v, d: real(v, d))
    assert not schur._kernel_route(0, torch.float32)
    lm = schur._WindowLM(win["values"], win["w"], win["masks"], win["cfg"], LMConfig(), win["w"].X_init[0], 0)
    assert not lm.kernels and lm.args is None


def test_the_card_checks_hold_the_plain_versions_to_themselves(states):
    """`testing/window_check.py`, the card's checks of K7-K9, with the plain
    versions standing in for the kernels on the CPU: every output of each
    piece (the head too) equal with zero error, twice bit for bit, and a
    failed factorisation's step rejected with the state kept."""
    from dynosam_tpu_torch.testing import window_check as wc

    lm, s0 = states["motion"]
    tree_copy_(lm.s, s0)
    plain = {"head": schur.window_head_plain, "build": schur.window_build_plain,
             "step": schur.window_step_plain, "update": schur.window_update_plain}
    pieces = wc.Pieces(lm, kernels=plain)
    for piece, r in wc.hold_pieces(pieces, "cpu", out=lambda line: None).items():
        assert not r["bad"] and r["repeat"] and r["max_abs_err"] == 0.0, piece
    assert wc.hold_failed_step(pieces, "cpu", out=lambda line: None)
    tree_copy_(lm.s, s0)


def _fault_at_smallest_block(x: torch.Tensor, tiles) -> tuple:
    """The index of the largest entry of `x`'s nonzero block (`tiles`, as
    `window_check.TILES`) whose largest entry is the smallest."""
    from dynosam_tpu_torch.testing import window_check as wc

    b = wc._block_max(x, tiles)
    b = torch.where(b > 0, b, torch.full_like(b, float("inf")))
    smallest = b == b.min()
    at = int(torch.where(smallest, x.abs(), torch.zeros_like(x)).reshape(-1).argmax())
    return np.unravel_index(at, tuple(x.shape))


@pytest.mark.parametrize("piece, field", [("build", "Hcc"), ("step", "Hred"), ("update", "H.t"),
                                          ("update", "step.dp")])
def test_the_card_checks_catch_a_fault_in_a_small_block(states, piece, field):
    """`window_check.hold_pieces` with a stand-in kernel: the plain version
    with one small part of one output scaled by 1.01 -- K7's Hcc odometry
    coupling of frames 4 and 5, K8's reduced-system entry of its smallest
    motion block, K9's smallest object-motion translation, K9's smallest
    dynamic-point step of its back-substitution -- reports that field, and
    only it, out of tolerance; in Hcc and Hred the faulty block is under a
    hundredth of its field's largest (the anchor's)."""
    from dynosam_tpu_torch.testing import window_check as wc

    lm, s0 = states["motion"]
    tree_copy_(lm.s, s0)
    fault = {}

    def build(a):
        schur.window_build_plain(a)
        a.s["sys"].Hcc[4, :, 5, :] *= 1.01
        a.s["sys"].Hcc[5, :, 4, :] *= 1.01

    def step(a):
        Hred, bred, back = schur.window_step_plain(a)
        Hred = Hred.clone()
        Hred[fault["at"]] *= 1.01
        return Hred, bred, back

    def update(a, sol, info, back):
        d = schur.window_update_plain(a, sol, info, back)
        if field == "H.t":
            a.s["vals"]["H"].t[fault["at"][:-1]] *= 1.01
        else:
            d["dp"][fault["at"][:-1]] *= 1.01
        return d

    pieces = wc.Pieces(lm, kernels={"build": build, "step": step, "update": update})
    plain = pieces.run(piece, False)[field]
    if piece == "build":
        block = plain[4, :, 5, :]
    else:
        nc = 6 * lm.s["sys"].Hcc.shape[0]
        part = plain[nc:, nc:] if piece == "step" else plain
        at = _fault_at_smallest_block(part, wc.TILES.get(field, (0,)))
        fault["at"] = tuple(int(i) + (nc if piece == "step" else 0) for i in at)
        block = plain[fault["at"][:-1]] if piece == "update" else plain[fault["at"]]
    assert float(block.abs().max()) > 0
    if piece != "update":
        assert float(block.abs().max()) < 1e-2 * float(plain.abs().max())
    report = wc.hold_pieces(pieces, "cpu", out=lambda line: None, held=(piece,))[piece]
    assert report["bad"] == [field] and report["repeat"], report["bad"]
    tree_copy_(lm.s, s0)


def test_the_bound_counts_the_same_work_for_either_contract(states):
    """`window_check.work`, the bound's FLOPs and bytes, from the system,
    state, window and reduced system alone: the same whether K8 hands K9
    the plain version's intermediates (`Yc_s`, `yb_s`, `Z`, `inv_c`) or
    nothing, as the kernels do; K8's bytes are the system read and the
    reduced system written, K9's the system, window and solution read and
    the state read and written."""
    from dynosam_tpu_torch.testing import window_check as wc

    lm, s0 = states["motion"]
    tree_copy_(lm.s, s0)
    pieces = wc.Pieces(lm, kernels={})
    plain = wc.work(pieces)
    sol, info, back = pieces.fixed
    assert set(back) >= {"Yc_s", "yb_s", "Z", "inv_c"}
    pieces.fixed = (sol, info, {})
    assert wc.work(pieces) == plain
    sysf, v = s0["sys"], s0["vals"]
    n = sol.shape[0]
    sys_bytes = sum(t.numel() * 4 for t in sysf)
    state_bytes = sum(t.numel() * 4 for t in (v["X"].R, v["X"].t, v["H"].R, v["H"].t, v["sp"], v["dp"], *s0["res"]))
    assert plain["step"][1] == sys_bytes + 4 * (n * n + n)
    assert plain["update"][1] - 2 * state_bytes - sys_bytes - 4 * n > 0
    assert all(f > 0 for f, _ in plain.values())
    tree_copy_(lm.s, s0)
