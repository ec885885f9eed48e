"""Card-only checks of the port: each Hopper kernel against its plain
PyTorch version on the same CUDA tensors, short frontend-only runs
(Shi-Tomasi and ORB detectors) that must launch their kernels on every
steady frame, backend solves (a direct-Schur window of each formulation,
a batched dispatch of two windows, a full-batch LM-PCG) on the card
against the CPU, the window solve's CUDA graphs against its eager loop,
and drift recovery in full for both updaters.

Marked `cuda`; a fixture skips them where no card is present.  On a machine
with a card and the CUDA toolkit (this file imports neither JAX nor the
repository's conftest):

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" --noconftest -q
"""

import numpy as np
import pytest
import torch

from dynosam_tpu_torch import kernels
from dynosam_tpu_torch.kernels import lk, orb_sample, point_sample, response

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture
def frames(cuda):
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene

    return RenderedScene(RenderConfig(n_frames=4, h=192, w=256, n_objects=2), device=cuda).frames()


def test_k1_lk_level_matches_plain(cuda, frames):
    """K1 against its plain version: 0.05 px on g, 0.1 grey levels on err
    (block-reduction order; the eps stop may fall one step apart)."""
    rng = np.random.default_rng(0)
    n = 300
    p = torch.as_tensor(rng.uniform([12, 12], [244, 180], (n, 2)).astype(np.float32), device=cuda)
    valid = torch.as_tensor(rng.random(n) > 0.4, device=cuda)
    g0 = torch.as_tensor(rng.normal(0, 1, (n, 2)).astype(np.float32), device=cuda)
    f0, f1 = frames[0], frames[1]
    for win, iters, eps in ((21, 10, 0.01), (13, 30, 0.0)):
        kernels.reset_launch_counts()
        g, err = lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
        gp, ep = lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["lk"] == 1
        assert float((g - gp).abs().max()) < 0.05
        assert float((err - ep).abs().max()) < 0.1
        assert torch.equal(g[~valid], g0[~valid]) and bool((err[~valid] == 0).all())


def test_k1_lk_level_border_and_off_tile_slots(cuda, frames):
    """K1 against its plain version where the kernel's staged windows are
    at their edges, at the same 0.05 px / 0.1 grey-level tolerances: slots
    within 10 px of the image border (the replicated tile edge stands in
    for the per-sample clamp), and slots whose warm start is 6-9 px off,
    beyond the 4 px margin of the staged `cur` window, so steps restage it."""
    from dynosam_tpu_torch.ops.klt import flow_at

    f0, f1 = frames[0], frames[1]
    h, w = f0.gray.shape
    rng = np.random.default_rng(3)
    n = 200
    side, t, d = rng.integers(0, 4, n), rng.uniform(0, 1, n), rng.uniform(0, 10, n)
    xb = np.where(side == 0, d, np.where(side == 1, w - 1 - d, t * (w - 1)))
    yb = np.where(side == 2, d, np.where(side == 3, h - 1 - d, t * (h - 1)))
    pb = torch.as_tensor(np.stack([xb, yb], -1).astype(np.float32), device=cuda)
    po = torch.as_tensor(rng.uniform([30, 30], [w - 30, h - 30], (n, 2)).astype(np.float32), device=cuda)
    ang, rad = rng.uniform(0, 2 * np.pi, n), rng.uniform(6, 9, n)
    off = torch.as_tensor(np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32), device=cuda)
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    for p, g0 in ((pb, flow_at(f0.flow, pb)), (po, flow_at(f0.flow, po) + off)):
        g, err = lk.lk_level(f0.gray, f1.gray, p, g0, valid, 21, 10, 0.01)
        gp, ep = lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, 21, 10, 0.01)
        torch.cuda.synchronize()
        assert float((g - gp).abs().max()) < 0.05
        assert float((err - ep).abs().max()) < 0.1


def test_k2_point_sample_matches_plain(cuda, frames):
    """K2 against its plain version: bilinear to 1e-5 of max |value|,
    nearest exactly, invalid rows 0, half-way coordinates rounding to
    even."""
    f = frames[1]
    rng = np.random.default_rng(1)
    uv = rng.uniform([-3, -3], [259, 195], (1000, 2)).astype(np.float32)
    uv[:4] = [[6.5, 3.5], [7.5, 8.5], [0.5, 0.5], [255.0, 191.0]]
    uv = torch.as_tensor(uv, device=cuda)
    valid = torch.as_tensor(rng.random(1000) > 0.3, device=cuda)
    valid[:4] = True
    stack = torch.stack([f.depth, f.mask.float(), f.gray]).contiguous()
    modes = ("bilinear", "nearest", "bilinear")
    got = point_sample.point_sample(stack, uv, modes, valid)
    want = point_sample.point_sample_plain(stack, uv, modes, valid)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 1], want[:, 1])
    for c in (0, 2):
        assert float((got[:, c] - want[:, c]).abs().max()) <= 1e-5 * float(want[:, c].abs().max())
    assert bool((got[~valid] == 0).all())
    idx = torch.tensor([[6, 4], [8, 8], [0, 0]], device=cuda)   # (x, y): 6.5->6, 3.5->4, 8.5->8, 0.5->0
    assert torch.equal(got[:3, 1], f.mask.float()[idx[:, 1], idx[:, 0]])


def test_k2_reads_int_bool_and_strided_channels_in_place(cuda, frames):
    """K2 on channels passed as they are: float32 depth, the int32 mask, a
    bool mask and the two strided planes of the (H, W, 2) flow, in both
    modes.  Nearest taps equal the plain version exactly, bilinear taps to
    1e-5 of max |value|; `valid=None` samples every row; each call adds one
    launch."""
    f = frames[1]
    rng = np.random.default_rng(2)
    uv = torch.as_tensor(rng.uniform([-3, -3], [259, 195], (777, 2)).astype(np.float32), device=cuda)
    fx, fy = f.flow.unbind(-1)
    forbid = f.mask != 0
    chans = (f.depth, f.mask, f.mask, forbid, forbid, fx, fy, f.depth)
    modes = ("bilinear", "nearest", "bilinear", "nearest", "bilinear", "bilinear", "bilinear", "nearest")
    valid = torch.as_tensor(rng.random(777) > 0.3, device=cuda)
    strided_uv = torch.cat([uv, uv], 1)[:, :2]                  # strides (4, 1)
    strided_valid = torch.stack([valid, valid], 1)[:, 0]        # stride 2
    for uv_, valid in ((uv, None), (uv, valid), (strided_uv, strided_valid)):
        before = kernels.launch_counts()["point_sample"]
        got = point_sample.point_sample(chans, uv_, modes, valid)
        assert kernels.launch_counts()["point_sample"] == before + 1
        want = point_sample.point_sample_plain(chans, uv_, modes, valid)
        torch.cuda.synchronize()
        assert got.shape == (777, 8) and got.dtype == torch.float32
        for c, m in enumerate(modes):
            if m == "nearest":
                assert torch.equal(got[:, c], want[:, c])
            else:
                assert float((got[:, c] - want[:, c]).abs().max()) <= 1e-5 * float(want[:, c].abs().max())
        if valid is not None:
            assert bool((got[~valid] == 0).all())
    assert torch.equal(got[:, 1], f.mask[uv[:, 1].round().clamp(0, 191).long(),
                                         uv[:, 0].round().clamp(0, 255).long()].float() * valid)


def test_k3_response_matches_plain(cuda, frames):
    """K3 against its plain version on the whole image, borders included:
    1e-5 of max |response|."""
    g = frames[0].gray
    got = response.shi_tomasi_response(g)
    want = response.shi_tomasi_response_plain(g)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(37, 53), (5, 1290), (400, 7), (1, 1), (384, 1280)])
def test_k3_response_on_shapes_off_its_tile(cuda, shape):
    """K3 against its plain version on uniform noise at shapes that are no
    multiple of its 28-column by 32-row block tile, down to one pixel, and
    at the KITTI frame's 384x1280: 1e-5 of max |response| (a 1x1 image has
    response 0 in both)."""
    g = torch.as_tensor(np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32), device=cuda)
    got = response.shi_tomasi_response(g)
    want = response.shi_tomasi_response_plain(g)
    torch.cuda.synchronize()
    assert got.shape == shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_pipeline_launches_every_kernel_on_every_steady_frame(cuda, frames):
    """Four frames of the frontend-only pipeline on the card: finite poses,
    and K1, K2 and K3 each launched on every frame after the first (K4, the
    ORB sampler, on none)."""
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.utils.config import CapacityConfig, DynoConfig, PipelineConfig

    scene = RenderedScene(RenderConfig(n_frames=4, h=192, w=256, n_objects=2), device=cuda)
    cfg = DynoConfig(pipeline=PipelineConfig(use_backend=False),
                     capacity=CapacityConfig(max_static_tracks=512, max_dynamic_tracks=1024, max_objects=8))
    pipe = DynoPipeline(scene.cam, cfg)
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    for k, f in enumerate(scene.frames()):
        pkt = pipe.spin_once(f)
        now = kernels.launch_counts()
        if k > 0:
            assert all(now[name] > prev[name] for name in ("lk", "point_sample", "response")), (k, prev, now)
        prev = now
    torch.cuda.synchronize()
    assert prev["orb_sample"] == 0
    assert bool(torch.isfinite(pkt.X_world.t).all())
    assert pkt.X_world.t.device.type == "cuda"


@pytest.mark.parametrize("n", [1, 7, 33, 2000])
def test_k4_orb_sample_matches_plain(cuda, frames, n):
    """K4 against its plain version on a two-level 192x256 canvas at n
    keypoints: counts that fill no block of the kernel (4 keypoints a block)
    and a frame's 2000.  The first keypoint is one `extract_orb` selects;
    then come keypoints off the canvas, on its corners, NaN ones and ones
    within 15 px of the seam between the levels (row 192), then the
    selected keypoints, then random ones.  The plain version repeats the
    kernel's arithmetic, so angles agree to 1e-5 rad and at least 99.9 % of
    the bits agree."""
    from dynosam_tpu_torch.frontend import orb

    pyr = orb.orb_pyramid(frames[0].gray, n_features=400, n_levels=2)
    hc, wc = pyr.canvas_raw.shape
    nan = float("nan")
    edge = torch.tensor([[-40.0, 3.0], [wc + 5.0, hc + 9.0], [0.0, 0.0], [wc - 1.0, hc - 1.0], [7.5, 8.5],
                         [nan, 20.0], [30.0, nan], [100.3, 188.4], [150.5, 206.2], [60.0, 192.0],
                         [3.0, 177.5], [wc - 2.0, 199.0]], device=cuda)
    rng = np.random.default_rng(n)
    rand = torch.as_tensor(rng.uniform([-20, -20], [wc + 20, hc + 20], (n, 2)).astype(np.float32), device=cuda)
    uv = torch.cat([pyr.canvas_uv[:1], edge, pyr.canvas_uv[1:], rand])[:n].contiguous()
    kernels.reset_launch_counts()
    ang, desc = orb_sample.orb_orientation_descriptors(pyr.canvas_raw, pyr.canvas_blur, uv)
    ang_p, desc_p = orb_sample.orb_orientation_descriptors_plain(pyr.canvas_raw, pyr.canvas_blur, uv)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["orb_sample"] == 1
    assert ang.shape == (n,) and desc.dtype == torch.int8 and desc.shape == (n, 256)
    assert bool(((desc == 1) | (desc == -1)).all()) and bool(torch.isfinite(ang).all())
    d = (ang - ang_p).abs()
    assert float(torch.minimum(d, 2 * np.pi - d).max()) <= 1e-5
    assert float((desc == desc_p).float().mean()) >= 0.999


def test_orb_pipeline_launches_k4_k1_k2_on_every_steady_frame(cuda):
    """Four frames of the ORB-mode frontend-only pipeline on the card:
    finite poses, K4, K1 and K2 launched on every frame after the first,
    K3 on none (the ORB branch has no Shi-Tomasi response)."""
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.utils.config import CapacityConfig, DynoConfig, FrontendConfig, PipelineConfig, TrackerConfig

    scene = RenderedScene(RenderConfig(n_frames=4, h=192, w=256, n_objects=2), device=cuda)
    cfg = DynoConfig(pipeline=PipelineConfig(use_backend=False),
                     frontend=FrontendConfig(tracker=TrackerConfig(feature_detector_type="orb", orb_n_levels=4)),
                     capacity=CapacityConfig(max_static_tracks=512, max_dynamic_tracks=1024, max_objects=8))
    pipe = DynoPipeline(scene.cam, cfg)
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    for k, f in enumerate(scene.frames()):
        pkt = pipe.spin_once(f)
        now = kernels.launch_counts()
        if k > 0:
            assert all(now[name] > prev[name] for name in ("orb_sample", "lk", "point_sample")), (k, prev, now)
        prev = now
    torch.cuda.synchronize()
    assert prev["response"] == 0
    assert bool(torch.isfinite(pkt.X_world.t).all())
    assert int(pipe.frontend_state.tracker.s_desc.abs().sum()) > 0


def _window_problem(device):
    """A window-10 simulator scenario on `device`: window, masks, initial
    values, and values moved off them (seeded on the CPU)."""
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend import map as bmap
    from dynosam_tpu_torch.core.lie import se3_exp, se3_retract
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
    from dynosam_tpu_torch.utils.config import BackendConfig

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
    return cfg, w, masks, v0, moved


def test_window_solve_on_the_card_matches_the_cpu(cuda):
    """One Schur step (lambda 1e-4, at values moved off the initial ones)
    and one 7-iteration LM solve of a window-10 simulator scenario, on the
    card and on the CPU: step deltas within 1e-3 of their max-abs, final
    error within rtol 3e-2, iterations within 1, camera translations within
    2e-3 m (the float32 tolerances of `tests/test_torch_schur.py`).  A
    failed Cholesky on the card gives a NaN step, not an exception."""
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.backend.solver import LMConfig

    out = {}
    for dev in (torch.device("cpu"), cuda):
        cfg, w, masks, v0, moved = _window_problem(dev)
        anchor = w.X_init[0]
        res = fm.world_motion_residuals(moved, w, masks, cfg, anchor)
        sys = schur.build_normal_system(moved, schur.sqrt_weights(res, fm.world_motion_families(cfg).robust),
                                        w, masks, cfg, anchor, res)
        step = schur.schur_step(sys, torch.tensor(1e-4, device=dev), 1e-6)
        bad = schur.schur_step(sys._replace(Hcc=-sys.Hcc), torch.tensor(1e-4, device=dev), 1e-6)
        lm = schur.lm_optimize_schur(v0, w, masks, cfg, LMConfig(max_iterations=7), anchor)
        out[dev.type] = (step, bad, lm)
    torch.cuda.synchronize()
    (s_cpu, _, lm_cpu), (s_gpu, bad_gpu, lm_gpu) = out["cpu"], out["cuda"]
    for k in ("X", "P", "sp", "dp"):
        assert s_gpu[k].device.type == "cuda"
        d = float((s_gpu[k].cpu() - s_cpu[k]).abs().max()) / float(s_cpu[k].abs().max())
        assert d <= 1e-3, (k, d)
    assert bool(torch.isnan(bad_gpu["X"]).all())
    assert float(lm_gpu.error) < float(lm_gpu.initial_error)
    assert float(lm_gpu.error) == pytest.approx(float(lm_cpu.error), rel=3e-2)
    assert abs(lm_gpu.iterations - lm_cpu.iterations) <= 1
    assert float((lm_gpu.values["X"].t.cpu() - lm_cpu.values["X"].t).abs().max()) <= 2e-3


def test_lm_pcg_full_batch_on_the_card_matches_the_cpu(cuda):
    """The full-batch LM-PCG (`use_schur=False`, 8 simulator frames, 30 LM
    iterations) through `run_from_packets` on the card and on the CPU:
    final error within rtol 1e-2 and camera translations within 1e-4 m (the
    float32 floor of `tests/test_torch_solver.py`)."""
    from dynosam_tpu_torch.pipeline import run_from_packets
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
    from dynosam_tpu_torch.utils.config import BackendConfig, CapacityConfig, DynoConfig

    scfg = ScenarioConfig(n_frames=8)
    cfg = DynoConfig(backend=BackendConfig(use_full_batch_opt=True, use_schur=False),
                     capacity=CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd,
                                             max_objects=scfg.no, max_frames=scfg.n_frames))
    packets = Scenario(scfg).frontend_outputs()
    out = {dev.type: run_from_packets(packets, cfg, device=dev).last_result
           for dev in (torch.device("cpu"), cuda)}
    cpu, gpu = out["cpu"], out["cuda"]
    assert gpu.values["X"].t.device.type == "cuda"
    assert float(gpu.error) < 1e-3 * float(gpu.initial_error)
    assert float(gpu.error) == pytest.approx(float(cpu.error), rel=1e-2)
    assert float((gpu.values["X"].t.cpu() - cpu.values["X"].t).abs().max()) <= 1e-4


def _bit_equal(a, b) -> bool:
    leaves = torch.utils._pytree.tree_leaves
    return (all(torch.equal(x, y) for x, y in zip(leaves(a.values), leaves(b.values)))
            and torch.equal(a.error, b.error) and torch.equal(a.lam, b.lam)
            and (a.iterations, a.converged) == (b.iterations, b.converged))


@pytest.mark.parametrize("updater", [0, 1], ids=["world_motion", "world_pose_fixed_lag"])
def test_graphed_window_solves_match_the_eager_loop(cuda, monkeypatch, updater):
    """Four consecutive windows (three in stream and `finish`'s) of a
    22-frame simulator sequence through `RGBDBackend` on the card, with
    each LM iteration replayed as a CUDA graph (the default) and with the
    eager loop (`lm_optimize_schur(_graphs=False)`): every solve equal bit
    for bit (WorldPose with the fixed-lag prior too), since a replay runs
    the eager loop's kernels in the same order.  A second, fresh backend
    captures nothing, replays the head plus one graph per LM iteration,
    and equals the first bit for bit."""
    import functools

    from dynosam_tpu_torch.backend import backend as tbe
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
    from dynosam_tpu_torch.utils.config import BackendConfig, CapacityConfig

    scfg = ScenarioConfig(n_frames=22)
    packets = Scenario(scfg).frontend_outputs()
    cfg = BackendConfig(backend_updater_enum=updater, use_fixed_lag_prior=updater == 1)
    cap = CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd, max_objects=scfg.no, max_frames=64)

    def run():
        be = tbe.RGBDBackend(cfg, cap, device=cuda)
        for p in packets:
            be.spin(p)
        be.finish()
        torch.cuda.synchronize()
        return [r for _, _, r, _ in be.solves]

    graphed = run()
    before = schur.graph_counts()
    again = run()
    after = schur.graph_counts()
    monkeypatch.setattr(tbe, "lm_optimize_schur", functools.partial(tbe.lm_optimize_schur, _graphs=False))
    eager = run()
    assert len(graphed) == len(eager) == 4
    assert after["captures"] == before["captures"]
    assert after["replays"] - before["replays"] == sum(1 + r.iterations for r in again)
    for g, a, e in zip(graphed, again, eager):
        assert g.values["X"].t.device.type == "cuda" and float(g.error) < float(g.initial_error)
        assert _bit_equal(g, a) and _bit_equal(g, e)


def test_graphed_window_solve_rejects_failed_choleskys_as_the_eager_loop(cuda, monkeypatch):
    """A normal system whose reduced Cholesky fails (Hcc negated, as in
    `test_window_solve_on_the_card_matches_the_cpu`) gives a NaN step on
    every iteration: the graphed solve rejects each one, raises lambda to
    its cap and ends on its initial values and error, as the eager loop
    does, with the same iterations and lambda."""
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.backend.solver import LMConfig

    real_build = schur.build_normal_system
    monkeypatch.setattr(schur, "build_normal_system",
                        lambda *a, **k: (lambda s: s._replace(Hcc=-s.Hcc))(real_build(*a, **k)))
    cfg, w, masks, v0, _ = _window_problem(cuda)
    lm = LMConfig(max_iterations=30)
    captures = schur.graph_counts()["captures"]
    got = schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0])
    want = schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0], _graphs=False)
    torch.cuda.synchronize()
    assert schur.graph_counts()["captures"] == captures + 1
    assert got.converged and got.iterations == want.iterations
    assert torch.equal(got.lam, want.lam) and torch.equal(got.error, got.initial_error)
    assert torch.equal(got.values["X"].t, v0["X"].t) and torch.equal(got.error, want.error)


def _round16(tree):
    """Floating tensors of a tree (dicts, SE3) rounded to bfloat16 and back."""
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.bfloat16).to(tree.dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _round16(v) for k, v in tree.items()}
    return type(tree)(*(_round16(v) for v in tree))


def test_a_replaced_retraction_captures_anew_on_the_card(cuda, monkeypatch):
    """After a window shape is captured, `schur.retract_tree` replaced by
    one that rounds the state to bfloat16 (the benchmark's `bf16_state`
    control) keys a new capture: the graphed solve equals the eager loop
    under the replacement bit for bit and differs from the sound solve."""
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.backend.solver import LMConfig

    cfg, w, masks, _, moved = _window_problem(cuda)
    lm = LMConfig(max_iterations=10)
    sound = schur.lm_optimize_schur(moved, w, masks, cfg, lm, w.X_init[0])
    captures = schur.graph_counts()["captures"]
    real = schur.retract_tree
    monkeypatch.setattr(schur, "retract_tree", lambda v, d: _round16(real(v, d)))
    got = schur.lm_optimize_schur(moved, w, masks, cfg, lm, w.X_init[0])
    want = schur.lm_optimize_schur(moved, w, masks, cfg, lm, w.X_init[0], _graphs=False)
    torch.cuda.synchronize()
    assert schur.graph_counts()["captures"] == captures + 1
    assert _bit_equal(got, want) and not _bit_equal(got, sound)


def test_window_capture_beside_a_thread_that_uses_the_card(cuda, monkeypatch, frames):
    """A window shape captured while another thread rectifies host frames
    on the card and reads them back, allocating fresh device memory each
    round (a loader's prefetch thread with `distortion` set does the
    copies, allocations and launches): the capture succeeds, the thread
    runs on through it without an error, and the graphed solve equals the
    eager loop bit for bit."""
    import threading

    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.backend.solver import LMConfig
    from dynosam_tpu_torch.core.distortion import Distortion
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.frontend.rectify import make_rectifier
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene

    cam = RenderedScene(RenderConfig(n_frames=1, h=192, w=256, n_objects=2), device=cuda).cam
    rectify = make_rectifier(cam, Distortion((-0.15, 0.03, 0.0, 0.0)), device=cuda)
    host_frame = to_device(frames[1], "cpu")
    stop, errors, rounds, held = threading.Event(), [], [0], []

    def worker():
        try:
            while not stop.is_set():
                if len(held) < 1000:      # 4 MiB a round, kept: the allocator must reserve new memory
                    held.append(torch.empty(2 ** 20, device=cuda))
                rectify(host_frame).gray.cpu()
                rounds[0] += 1
        except BaseException as e:        # noqa: BLE001 - reported by the test
            errors.append(e)

    monkeypatch.setattr(schur, "_WINDOW_LMS", type(schur._WINDOW_LMS)())
    cfg, w, masks, v0, _ = _window_problem(cuda)
    lm = LMConfig(max_iterations=10)
    captures = schur.graph_counts()["captures"]
    t = threading.Thread(target=worker)
    t.start()
    try:
        while rounds[0] < 3 and t.is_alive():
            stop.wait(0.01)
        before = rounds[0]
        got = schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0])
        during = rounds[0] - before
    finally:
        stop.set()
        t.join()
    held.clear()
    torch.cuda.synchronize()
    assert not errors, errors
    assert schur.graph_counts()["captures"] == captures + 1 and during > 0
    assert _bit_equal(got, schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0], _graphs=False))


def test_online_run_captures_its_window_while_the_prefetch_thread_rectifies(cuda, monkeypatch, tmp_path):
    """`run_and_log` over 14 rendered frames (192x256) served on the host
    with `distortion` set, so the loader's prefetch thread rectifies each
    frame on the card, with the window cache empty: the first window is
    captured mid-run, and the thread's rectification of frame 10 is held
    until a capture has begun and runs while it is open.  Every window
    then solves graphed (one capture, the head plus one replay per LM
    iteration) with its error down."""
    import threading
    import time

    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.core.distortion import Distortion
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.pipeline import run_and_log
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.testing.scenes import RenderedDataset
    from dynosam_tpu_torch.utils.config import CapacityConfig, DynoConfig

    scene = RenderedScene(RenderConfig(n_frames=14, h=192, w=256, n_objects=2), device=cuda)
    ds = RenderedDataset(scene, [to_device(f, "cpu") for f in scene.frames()])
    ds.distortion, ds.device = Distortion((-0.15, 0.03, 0.0, 0.0)), cuda
    real_rectify = ds._get_rectifier()
    capturing, spans, rects = threading.Event(), [], []
    real_begin, real_end = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.capture_end

    def begin(graph, *a, **k):
        real_begin(graph, *a, **k)
        spans.append([time.perf_counter(), None])
        capturing.set()
        time.sleep(0.2)                   # the capture stays open while the thread rectifies

    def end(graph, *a, **k):
        spans[-1][1] = time.perf_counter()
        real_end(graph, *a, **k)

    def rectify(f):
        if len(rects) == 10:
            capturing.wait(timeout=120)
        t0 = time.perf_counter()
        out = real_rectify(f)
        rects.append((t0, time.perf_counter()))
        return out

    monkeypatch.setattr(ds, "_get_rectifier", lambda: rectify)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", begin)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_end", end)
    monkeypatch.setattr(schur, "_WINDOW_LMS", type(schur._WINDOW_LMS)())
    before = schur.graph_counts()
    cfg = DynoConfig(capacity=CapacityConfig(max_static_tracks=512, max_dynamic_tracks=1024, max_objects=8))
    result = run_and_log(ds, cfg, str(tmp_path), device=cuda)
    torch.cuda.synchronize()
    after = schur.graph_counts()
    solved = [r for _, _, r, _ in result.backend.solves]
    assert len(rects) == 14 and len(solved) >= 2
    assert any(s0 <= t0 and t1 <= s1 for t0, t1 in rects for s0, s1 in spans), (rects, spans)
    assert after["captures"] == before["captures"] + 1
    assert after["replays"] - before["replays"] == sum(1 + r.iterations for r in solved)
    assert all(float(r.error) < float(r.initial_error) for r in solved)


def test_nan_debug_sees_a_graphed_window_solve(cuda):
    """After a window shape is captured, `nan_debug` still checks every
    operator of a solve of that shape (the eager loop runs under a dispatch
    mode) and names the first that gives a NaN."""
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.backend.solver import LMConfig
    from dynosam_tpu_torch.utils.debug import nan_debug

    cfg, w, masks, v0, _ = _window_problem(cuda)
    lm = LMConfig(max_iterations=3)
    schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0])
    bad = w.static_xyz.clone()
    bad[3, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="aten."):
        with nan_debug():
            schur.lm_optimize_schur(v0, w._replace(static_xyz=bad), masks, cfg, lm, w.X_init[0])


def test_world_pose_window_and_batched_windows_on_the_card_match_the_cpu(cuda):
    """WorldPose (updater 1) on the window-10 simulator scenario, card
    against CPU: one Schur step at lambda 1e-4 within 2e-2 of each delta's
    max-abs (the ~1e10-conditioned WorldPose step moves by 30 % when its
    inputs move by one part in 1e7, `tests/test_torch_world_pose.py`; card
    and CPU sum in other orders) and a 7-iteration LM with a full
    `anchor_prior_L` within rtol 3e-2 in error and 2e-3 m in camera
    translations (the float32 tolerances of the WorldMotion window above);
    and two windows of a 16-frame scenario in one batched
    dispatch (`backend.solve_windows`), card against CPU, camera
    translations within 2e-3 m, masks equal."""
    from dynosam_tpu_torch.backend import backend as tbe
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend import map as bmap
    from dynosam_tpu_torch.backend import schur
    from dynosam_tpu_torch.backend.solver import LMConfig
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
    from dynosam_tpu_torch.utils.config import BackendConfig

    Lp = torch.linalg.cholesky(torch.eye(6, dtype=torch.float64) * 1e8 + 1e7).float()
    out = {}
    for dev in (torch.device("cpu"), cuda):
        cfg, w, masks, _, _ = _window_problem(dev)
        v0 = fm.init_values_world_pose(w, masks, cfg)
        anchor = w.X_init[0]
        res = fm.world_pose_residuals(v0, w, masks, cfg, anchor)
        sys = schur.build_normal_system_pose(v0, schur.sqrt_weights(res, fm.world_pose_families(cfg).robust),
                                             w, masks, cfg, anchor, res)
        step = schur.schur_step(sys, torch.tensor(1e-4, device=dev), 1e-6, formulation=1)
        lm = schur.lm_optimize_schur(v0, w, masks, cfg, LMConfig(max_iterations=7), anchor, formulation=1,
                                     anchor_prior_L=Lp.to(dev))
        scfg = ScenarioConfig(n_frames=16)
        m = bmap.MeasurementMap.create(16, scfg.ns, scfg.nd, scfg.no, device=dev)
        for k, p in enumerate(Scenario(scfg).frontend_outputs()):
            bmap.update_map(m, to_device(p, dev), k)
        bcfg = BackendConfig(window_max_static=128, window_max_dynamic=96, window_max_objects=3,
                             lm_max_iterations=7)
        est = tbe.EstimateStore.create(16, scfg.ns, scfg.nd, scfg.no, device=dev)
        tbe.solve_windows(est, m, [0, 6], 10, bcfg, tbe.lm_config(bcfg))
        out[dev.type] = (step, lm, est)
    torch.cuda.synchronize()
    (s_cpu, lm_cpu, est_cpu), (s_gpu, lm_gpu, est_gpu) = out["cpu"], out["cuda"]
    for k in ("X", "P", "sp", "dp"):
        d = float((s_gpu[k].cpu() - s_cpu[k]).abs().max()) / float(s_cpu[k].abs().max())
        assert d <= 2e-2, (k, d)
    assert float(lm_gpu.error) < float(lm_gpu.initial_error)
    assert float(lm_gpu.error) == pytest.approx(float(lm_cpu.error), rel=3e-2)
    assert float((lm_gpu.values["X"].t.cpu() - lm_cpu.values["X"].t).abs().max()) <= 2e-3
    for f in ("X_valid", "motion_valid", "dyn_valid", "static_valid"):
        assert torch.equal(getattr(est_gpu, f).cpu(), getattr(est_cpu, f)), f
    assert float((est_gpu.X.t.cpu() - est_cpu.X.t).abs().max()) <= 2e-3


@pytest.mark.parametrize("updater", [0, 1])
def test_drift_recovery_on_the_card(cuda, updater):
    """`tests/test_accuracy_regression.py:166-228` on the card, in full: the
    golden scene's frontend packets with a growing camera drift, odometry
    sigmas loosened 10x, the full-batch backend with 100 LM iterations
    allowed; the recovered camera ATE below the corrupted ATE / 1.8 and
    below 0.11 m (JAX's bounds)."""
    import dataclasses

    from dynosam_tpu_torch.core.lie import se3_compose, se3_exp
    from dynosam_tpu_torch.eval import metrics
    from dynosam_tpu_torch.pipeline import DynoPipeline, run_from_packets
    from dynosam_tpu_torch.testing.scenes import GOLDEN_FRAMES, golden_config, golden_dataset

    ds = golden_dataset(cuda)
    fe_cfg = dataclasses.replace(golden_config(True), pipeline=dataclasses.replace(golden_config().pipeline,
                                                                                   use_backend=False))
    packets = DynoPipeline(ds.camera_params(), fe_cfg, device=cuda).run(ds.frames()).packets
    drift = torch.tensor([0.0, 0.0015, 0.0, 0.02, 0.008, 0.0], device=cuda)
    corrupted = [p._replace(X_world=se3_compose(se3_exp(drift * float(k)), p.X_world)) for k, p in enumerate(packets)]
    gt = np.stack([ds.ground_truth(k).X_world for k in range(GOLDEN_FRAMES)])

    def ate(R, t, valid):
        T = np.tile(np.eye(4), (int(valid.sum()), 1, 1))
        T[:, :3, :3] = R.double().cpu().numpy()[valid]
        T[:, :3, 3] = t.double().cpu().numpy()[valid]
        return metrics.ate(T, gt[valid])["trans"].rmse

    corrupted_ate = ate(torch.stack([p.X_world.R for p in corrupted]), torch.stack([p.X_world.t for p in corrupted]),
                        np.ones(GOLDEN_FRAMES, bool))
    assert corrupted_ate > 0.08, corrupted_ate
    cfg = golden_config(True)
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, backend_updater_enum=updater, lm_max_iterations=100, odometry_translation_sigma=1.0,
        odometry_rotation_sigma=0.5))
    be = run_from_packets(corrupted, cfg, device=cuda)
    X, xv = be.camera_poses()
    rec = ate(X.R, X.t, xv.cpu().numpy())
    assert rec < corrupted_ate / 1.8, (rec, corrupted_ate)
    assert rec < 0.11, rec


def test_rectifier_on_the_card_matches_the_cpu(cuda, frames):
    """The rectifier on the card (one K2 launch per frame over the H * W
    map) against the same rectifier on the CPU (K2's plain version): gray
    and flow within 1e-3, depth and mask equal; a host mask is rectified on
    the host, to the same labels."""
    from dynosam_tpu_torch.core.distortion import Distortion
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.frontend.rectify import make_rectifier
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene

    cam = RenderedScene(RenderConfig(n_frames=1, h=192, w=256, n_objects=2), device=cuda).cam
    dist = Distortion((-0.15, 0.03, 0.0, 0.0))
    kernels.reset_launch_counts()
    rectify = make_rectifier(cam, dist, device=cuda)
    got = rectify(frames[1])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["point_sample"] == 1
    want = make_rectifier(cam, dist, device="cpu")(to_device(frames[1], "cpu"))
    assert float((got.gray.cpu() - want.gray).abs().max()) < 1e-3
    assert float((got.flow.cpu() - want.flow).abs().max()) < 1e-3
    assert torch.equal(got.depth.cpu(), want.depth) and torch.equal(got.mask.cpu(), want.mask)
    host = rectify(frames[1]._replace(mask=frames[1].mask.cpu()))
    assert host.gray.is_cuda and not host.mask.is_cuda and torch.equal(host.mask, want.mask)


def test_block_match_and_mask_ops_on_the_card_match_the_cpu(cuda, frames):
    """The block matcher and mask propagation on the card against the CPU:
    the same valid pixels and disparities within 1e-4 px; labels equal."""
    from scipy.ndimage import gaussian_filter

    from dynosam_tpu_torch.frontend.mask_ops import object_bboxes, propagate_mask
    from dynosam_tpu_torch.frontend.stereo import block_match

    tex = gaussian_filter(np.random.default_rng(0).uniform(0, 255, (96, 160)), 1.0).astype(np.float32)
    left, right = torch.as_tensor(tex[:, 16:144].copy()), torch.as_tensor(tex[:, 24:152].copy())
    got = block_match(left.to(cuda), right.to(cuda), max_disparity=32).cpu()
    want = block_match(left, right, max_disparity=32)
    assert torch.equal(got > 0, want > 0)
    assert float((got - want).abs().max()) < 1e-4
    prev, cur = frames[0].mask, frames[1].mask.clone()
    cur[cur == int(cur.max())] = 0
    p = propagate_mask(prev, frames[0].flow, cur)
    assert torch.equal(p.cpu(), propagate_mask(prev.cpu(), frames[0].flow.cpu(), cur.cpu()))
    for a, b in zip(object_bboxes(p, 16), object_bboxes(p.cpu(), 16)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("solver", ["essential", "two_point"])
def test_epipolar_ransac_on_the_card_matches_the_cpu(cuda, solver, dtype):
    """The 2d2d RANSACs on the same hypothesis indices on the card and on
    the CPU.  In float64 the same inliers and poses within 1e-8.  In
    float32 (the precision of the frontend) an 8-point null vector from
    cuSOLVER and from LAPACK may differ by far more (measured on the card:
    5.1e-3 in the unit translation with all 120 inliers on both sides), so
    both are held to the band of `tests/test_epipolar.py` (rotation within
    0.01 rad, unit translation within 0.97 of the truth) and to each other
    at 0.02, inlier sets within three points."""
    from dynosam_tpu_torch.core.camera import CameraParams, backproject, project_local
    from dynosam_tpu_torch.core.lie import se3_apply, se3_exp, so3_log
    from dynosam_tpu_torch.ops import epipolar

    cam = CameraParams.create(320.0, 320.0, 320.0, 240.0, 640, 480)
    rng = np.random.default_rng(0)
    rel = se3_exp(torch.tensor([0.02, -0.03, 0.01, 0.3, 0.05, 0.1], dtype=torch.float64))
    uv1 = torch.as_tensor(rng.uniform(60, [580, 420], (120, 2)), dtype=torch.float64)
    p = backproject(cam, uv1, torch.as_tensor(rng.uniform(4, 30, 120), dtype=torch.float64))
    uv2 = project_local(cam, se3_apply(rel, p))[0] + torch.as_tensor(rng.normal(0, 0.2, (120, 2)))
    valid = torch.ones(120, dtype=torch.bool)
    idx = torch.as_tensor(rng.integers(0, 120, (300, 8 if solver == "essential" else 2)))
    out = []
    for dev in (cuda, "cpu"):
        args = (uv1.to(dev, dtype), uv2.to(dev, dtype), valid.to(dev), cam)
        if solver == "essential":
            r = epipolar.ransac_essential(*args, iters=300, threshold=2e-6, idx=idx.to(dev))
        else:
            r = epipolar.ransac_translation_given_rot(*args, rel.R.to(dev, dtype), iters=300, threshold=2e-6,
                                                      idx=idx.to(dev))
        out.append(r)
    a, b = out
    dR = float((a.rel_pose.R.cpu() - b.rel_pose.R).abs().max())
    dt = float((a.rel_pose.t.cpu() - b.rel_pose.t).abs().max())
    if dtype == torch.float64:
        assert torch.equal(a.inliers.cpu(), b.inliers)
        assert dR < 1e-8 and dt < 1e-8
        return
    assert dR < 0.02 and dt < 0.02
    assert int((a.inliers.cpu() != b.inliers).sum()) <= 3
    t_gt = rel.t / torch.linalg.vector_norm(rel.t)
    for r in (a, b):
        R = r.rel_pose.R.cpu().double()
        assert float(torch.linalg.vector_norm(so3_log(rel.R.t() @ R))) < 0.01
        assert float(t_gt @ r.rel_pose.t.cpu().double()) > 0.97


def test_multi_sequence_on_the_card_matches_single_sequence_runs(cuda):
    """`MultiSequencePipeline` over two rendered sequences (192x256, 4
    frames, seeds 0 and 1) on the card: each sequence's packets equal its
    single-sequence `frontend_step` run with the same generators, and K1-K3
    launch as often as in the two runs together (the card counterpart of
    `chip_smoke.py`'s multi-sequence phase)."""
    from dynosam_tpu_torch.frontend.frontend import FrontendState, frontend_step
    from dynosam_tpu_torch.parallel.batch_eval import MultiSequencePipeline, frame_generator
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.testing.scenes import RenderedDataset
    from dynosam_tpu_torch.utils.config import FrontendConfig, TrackerConfig

    scenes = [RenderedScene(RenderConfig(n_frames=4, h=192, w=256, n_objects=2, seed=s), device=cuda)
              for s in (0, 1)]
    cfg = FrontendConfig(tracker=TrackerConfig(max_features_per_frame=300))
    kernels.reset_launch_counts()
    packets = MultiSequencePipeline([RenderedDataset(s) for s in scenes], cfg, caps=(512, 1024, 8),
                                    device=cuda).run(4)
    torch.cuda.synchronize()
    batched = kernels.launch_counts()
    kernels.reset_launch_counts()
    for s, scene in enumerate(scenes):
        state, prev = FrontendState.create(512, 1024, 8, device=cuda), None
        for k, f in enumerate(scene.frames()):
            state, pkt, _, _ = frontend_step(state, prev if prev is not None else f, f, scene.cam, cfg,
                                             generator=frame_generator(k, s, cuda), first_frame=k == 0, device=cuda)
            prev = f
            got = torch.utils._pytree.tree_leaves(packets[k])
            want = torch.utils._pytree.tree_leaves(pkt)
            assert all(torch.equal(a[s], b) for a, b in zip(got, want)), (s, k)
    torch.cuda.synchronize()
    single = kernels.launch_counts()
    assert batched == single and all(batched[n] > 0 for n in ("lk", "point_sample", "response")), (batched, single)


def test_distributed_solves_on_a_one_rank_nccl_group(cuda):
    """A one-rank NCCL group on the card: `distributed_schur_optimize`
    for both updaters on the window-10 simulator scenario against
    `lm_optimize_schur` (iterations within 1, error within rtol 3e-2,
    camera translations within 2e-3 m: the float32 tolerances of
    `tests/test_torch_schur.py`), with 2 collectives per LM iteration on
    one frame block (the error and the packed all_reduce); and
    `distributed_optimize` on 8 simulator frames against `lm_optimize`
    with Hutchinson's diagonal, both drawing their probes from a generator
    seeded 0 on the card.  The group is destroyed afterwards."""
    import torch.distributed as dist

    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend import map as bmap
    from dynosam_tpu_torch.backend.schur import lm_optimize_schur, world_motion_normal_product
    from dynosam_tpu_torch.backend.solver import LMConfig, lm_optimize
    from dynosam_tpu_torch.frontend.frontend import to_device
    from dynosam_tpu_torch.parallel import multihost
    from dynosam_tpu_torch.parallel.distributed_ba import distributed_optimize
    from dynosam_tpu_torch.parallel.mesh import make_mesh
    from dynosam_tpu_torch.parallel.schur_dist import distributed_schur_optimize
    from dynosam_tpu_torch.testing.gloo import free_port
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
    from dynosam_tpu_torch.utils.config import BackendConfig

    scfg = ScenarioConfig(n_frames=10)
    m = bmap.MeasurementMap.create(10, scfg.ns, scfg.nd, scfg.no, device=cuda)
    for k, p in enumerate(Scenario(scfg).frontend_outputs()):
        bmap.update_map(m, to_device(p, cuda), k)
    assert multihost.initialize(f"localhost:{free_port()}", 1, 0, device="cuda").type == "cuda"
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh(1)
        calls = {"n": 0}
        real = dist.all_reduce

        def counted(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        for updater in (0, 1):
            cfg = BackendConfig(backend_updater_enum=updater)
            w = bmap.slice_window(m, 0, 10)
            masks = fm.build_masks(w, cfg)
            v0 = fm.init_values(w, masks, cfg) if updater == 0 else fm.init_values_world_pose(w, masks, cfg)
            lm = LMConfig(max_iterations=7)
            ref = lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0], formulation=updater)
            calls["n"] = 0
            dist.all_reduce = counted
            try:
                res = distributed_schur_optimize(m, 10, cfg, mesh=mesh, updater=updater, lm_cfg=lm)
            finally:
                dist.all_reduce = real
            assert res.values["X"].t.device.type == "cuda"
            assert abs(res.iterations - ref.iterations) <= 1
            assert float(res.error) == pytest.approx(float(ref.error), rel=3e-2)
            assert float((res.values["X"].t - ref.values["X"].t).abs().max()) <= 2e-3
            assert calls["n"] == 1 + 2 * res.iterations

        cfg = BackendConfig()
        lm = LMConfig(max_iterations=6, cg_max_iterations=60)
        w = bmap.slice_window(m, 0, 8)
        masks = fm.build_masks(w, cfg)
        a = w.X_init[0]
        ref = lm_optimize(lambda v: fm.world_motion_residuals(v, w, masks, cfg, a), fm.world_motion_families(cfg).robust,
                          fm.init_values(w, masks, cfg), lm,
                          normal_fn=lambda v, sw, r: world_motion_normal_product(v, sw, r, w, masks, cfg, a))
        res = distributed_optimize(m, 8, cfg, mesh=mesh, lm_cfg=lm)
        assert res.iterations == ref.iterations
        assert float((res.values["X"].t - ref.values["X"].t).abs().max()) <= 2e-3
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
