"""Port parity for the ORB detector path: the BRIEF pattern, the pyramid
pieces, the plain version of kernel K4 (ORB orientation and steered BRIEF),
`extract_orb`, the matcher, the tracker's ORB branch (with and without
descriptor re-association) and the ORB-mode frontend-only pipeline.

Inputs come from numpy seeds or the JAX renderer and go through the JAX
function and the port's.  JAX's Pallas K4 runs in interpret mode on at most
32 keypoints; JAX results are computed once per module in fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.eval import metrics
from dynosam_tpu.frontend import orb as jorb
from dynosam_tpu.frontend.tracker import TrackerState as JTrackerState
from dynosam_tpu.frontend.tracker import track_frame as j_track_frame
from dynosam_tpu.ops import ransac as jran
from dynosam_tpu.ops.klt import flow_at as j_flow_at
from dynosam_tpu.ops.klt import klt_track as j_klt_track
from dynosam_tpu.ops.klt import nearest_at as j_nearest_at
from dynosam_tpu.ops.pallas import orb_sample as jk4
from dynosam_tpu.testing.render import RenderConfig, RenderedScene
from dynosam_tpu.utils.config import TrackerConfig as JTrackerConfig
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.frontend import orb as torb
from dynosam_tpu_torch.frontend.frontend import FrameImages
from dynosam_tpu_torch.frontend.tracker import track_frame
from dynosam_tpu_torch.kernels import orb_sample as tk4
from dynosam_tpu_torch.pipeline import DynoPipeline
from dynosam_tpu_torch.testing.scenes import kitti_orb_config
from dynosam_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

T = lambda a, dt=np.float32: torch.as_tensor(np.array(np.asarray(a), dt))

# The JAX references, each under one `jax.jit` as the JAX frontend runs them
# (called eagerly, every primitive compiles on its own)
_cell_max = jax.jit(jorb._cell_max, static_argnums=(1,))
_blur7 = jax.jit(jorb._gaussian_blur7)
_resize = jax.jit(jax.image.resize, static_argnames=("shape", "method"))
_orientations = jax.jit(jorb._orientations)
_descriptors = jax.jit(jorb._descriptors)
_k4_pallas = jax.jit(jk4.orb_orientation_descriptors, static_argnames=("interpret",))
_orb_detections = jax.jit(jorb.orb_detections)
_match_descriptors = jax.jit(jorb.match_descriptors, static_argnames=("max_hamming", "ratio", "cross_check"))

ANGLE_TOL = 1e-3     # rad: JAX's own band between its Pallas and XLA forms
BITS_MIN = 0.995     # descriptor-bit agreement, the same band


def _angle_err(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture(scope="module")
def frames():
    return RenderedScene(RenderConfig(n_frames=3, h=192, w=256)).frames()


@pytest.fixture(scope="module")
def extracted(frames):
    """`extract_orb` of JAX and the port on one 192x256 frame, 4 levels."""
    g = np.asarray(frames[0].gray)
    return jorb.extract_orb(jnp.asarray(g), n_features=400, n_levels=4), torb.extract_orb(T(g), 400, 4)


def test_pattern_equals_jax_bit_for_bit():
    """The BRIEF pattern (numpy default_rng(42)) and K4's de-interleaved
    taps are the JAX package's arrays exactly."""
    assert torb._PATTERN.dtype == np.float32 and torb._PATTERN.shape == (256, 2, 2)
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(tk4.TAPS, jk4._PAT)
    np.testing.assert_array_equal(torb._brief_pattern(), jorb._brief_pattern())


def test_level_quotas_and_cell_max_match_jax(rng):
    """Per-level quotas (KITTI: 434 at level 0 down to 122 at level 7,
    2000 in all) and the per-cell max, exactly."""
    for args in ((2000, 8, 1.2), (400, 4, 1.2), (1000, 8, 1.2), (7, 3, 2.0)):
        assert torb.features_per_level(*args) == jorb.features_per_level(*args)
    q = torb.features_per_level(2000, 8, 1.2)
    assert (q[0], q[-1], sum(q)) == (434, 122, 2000)
    resp = np.where(rng.uniform(size=(61, 83)) < 0.05, rng.uniform(0, 90, (61, 83)), 0.0).astype(np.float32)
    for cell in (35, 16, 4):
        np.testing.assert_array_equal(torb._cell_max(T(resp), cell).numpy(),
                                      np.asarray(_cell_max(jnp.asarray(resp), cell)))


def test_blur7_and_pyramid_resize_match_jax(rng):
    """The pre-BRIEF 7x7 blur within 1e-4 grey levels; the level resize
    (antialiased bilinear, `interpolate(antialias=True)` against
    `jax.image.resize`) within 1e-2 grey levels at all 7 KITTI scales."""
    g = rng.uniform(0, 255, (384, 1280)).astype(np.float32)
    np.testing.assert_allclose(torb._gaussian_blur7(T(g)).numpy(),
                               np.asarray(_blur7(jnp.asarray(g))), atol=1e-4)
    for lvl in range(1, 8):
        nh, nw = round(384 / 1.2 ** lvl), round(1280 / 1.2 ** lvl)
        want = np.asarray(_resize(jnp.asarray(g), shape=(nh, nw), method="bilinear"))
        got = torch.nn.functional.interpolate(T(g)[None, None], size=(nh, nw), mode="bilinear",
                                              antialias=True, align_corners=False)[0, 0].numpy()
        assert np.abs(got - want).max() <= 1e-2, lvl


def test_k4_plain_on_a_canvas_matches_jax_xla_and_pallas(frames, rng):
    """The plain K4 on a two-level canvas (level 0 over level 1, as
    `extract_orb` stacks them) against JAX's per-level XLA forms
    `_orientations` / `_descriptors` and JAX's Pallas kernel (interpret
    mode) on the same canvas, 16 keypoints per level inside the 19 px edge
    margin; and the port's own per-level XLA forms against JAX's.  Every
    comparison: angle < 1e-3 rad, bits > 0.995."""
    g = np.asarray(frames[0].gray)
    lv1 = np.asarray(jax.image.resize(jnp.asarray(g), (160, 213), method="bilinear"))
    levels = [g, lv1]
    blurs = [np.asarray(jorb._gaussian_blur7(jnp.asarray(x))) for x in levels]
    uvs = [rng.uniform([19, 19], [x.shape[1] - 20, x.shape[0] - 20], (16, 2)).astype(np.float32) for x in levels]
    canvas = np.concatenate([np.pad(x, ((0, 0), (0, 256 - x.shape[1]))) for x in levels])
    canvas_blur = np.concatenate([np.pad(x, ((0, 0), (0, 256 - x.shape[1]))) for x in blurs])
    uv_canvas = np.concatenate([uvs[0], uvs[1] + np.float32([0, 192])])

    ang_x = np.concatenate([np.asarray(_orientations(jnp.asarray(x), jnp.asarray(u)))
                            for x, u in zip(levels, uvs)])
    desc_x = np.concatenate([np.asarray(_descriptors(jnp.asarray(b), jnp.asarray(u), jnp.asarray(a)))
                             for b, u, a in zip(blurs, uvs, np.split(ang_x, 2))])
    ang_p, desc_p = _k4_pallas(jnp.asarray(canvas), jnp.asarray(canvas_blur), jnp.asarray(uv_canvas),
                               interpret=True)
    tk4.launches = 0
    ang_t, desc_t = tk4.orb_orientation_descriptors(T(canvas), T(canvas_blur), T(uv_canvas))
    assert tk4.launches == 0          # a CPU tensor runs the plain version
    assert ang_t.dtype == torch.float32 and desc_t.dtype == torch.int8 and desc_t.shape == (32, 256)
    assert set(np.unique(desc_t.numpy())) <= {-1, 1}
    for ang, desc in ((ang_x, desc_x), (np.asarray(ang_p), np.asarray(desc_p))):
        assert _angle_err(ang_t.numpy(), ang).max() < ANGLE_TOL
        assert (desc_t.numpy() == desc).mean() > BITS_MIN
    ang_f = torch.cat([torb._orientations(T(x), T(u)) for x, u in zip(levels, uvs)])
    desc_f = torch.cat([torb._descriptors(T(b), T(u), a) for b, u, a in zip(blurs, uvs, ang_f.split(16))])
    assert _angle_err(ang_f.numpy(), ang_x).max() < ANGLE_TOL
    assert (desc_f.numpy() == desc_x).mean() > BITS_MIN


def test_k4_plain_sums_in_kernel_order(rng):
    """The kernel-order moment sum equals a float64 sum to float32
    rounding, and repeats the kernel's order exactly: each of the 32 disc
    columns (one per lane) summed over its 31 rows top to bottom, then a
    shuffle butterfly (lane l adds lane l ^ o for o = 16, 8, 4, 2, 1),
    emulated here lane by lane in float32.  Keypoints off the canvas clip
    instead of failing."""
    p = rng.normal(0, 100, (5, 31, 32)).astype(np.float32)
    got = tk4._kernel_order_sum(T(p)).numpy()
    np.testing.assert_allclose(got, p.astype(np.float64).sum((1, 2)), rtol=0, atol=1e-3)
    lanes = p[:, 0].copy()
    for k in range(1, 31):
        lanes = lanes + p[:, k]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    assert (lanes == lanes[:, :1]).all()           # every lane holds the sum
    np.testing.assert_array_equal(got, lanes[:, 0])
    raw = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    uv = np.float32([[-30, 5], [70, 60], [25, 20], [np.nan, 3]])
    ang, desc = tk4.orb_orientation_descriptors_plain(T(raw), T(raw), T(uv))
    assert np.isfinite(ang.numpy()).all() and set(np.unique(desc.numpy())) <= {-1, 1}


@pytest.mark.parametrize("n", [1, 7, 33])
def test_k4_plain_at_counts_that_fill_no_block(frames, n):
    """The plain K4 at keypoint counts that fill neither the kernel's block
    (4 keypoints) nor the Pallas kernel's (16), on one 192x256 level inside
    the 19 px edge margin: against JAX's Pallas kernel (interpret mode) and
    its per-level XLA forms `_orientations` / `_descriptors`; angle
    < 1e-3 rad, bits > 0.995, the comparisons above."""
    g = np.asarray(frames[1].gray)
    blur = np.asarray(jorb._gaussian_blur7(jnp.asarray(g)))
    uv = np.random.default_rng(n).uniform([19, 19], [236, 172], (n, 2)).astype(np.float32)
    ang_x = np.asarray(_orientations(jnp.asarray(g), jnp.asarray(uv)))
    desc_x = np.asarray(_descriptors(jnp.asarray(blur), jnp.asarray(uv), jnp.asarray(ang_x)))
    ang_p, desc_p = _k4_pallas(jnp.asarray(g), jnp.asarray(blur), jnp.asarray(uv), interpret=True)
    ang_t, desc_t = tk4.orb_orientation_descriptors(T(g), T(blur), T(uv))
    assert ang_t.shape == (n,) and desc_t.shape == (n, 256)
    for ang, desc in ((ang_x, desc_x), (np.asarray(ang_p), np.asarray(desc_p))):
        assert _angle_err(ang_t.numpy(), ang).max() < ANGLE_TOL
        assert (desc_t.numpy() == desc).mean() > BITS_MIN


def test_extract_orb_matches_jax(extracted):
    """`extract_orb` at 192x256 with 4 levels against JAX's: the same
    validity mask, levels and scales; on keypoints valid on both sides the
    same pixels, FAST responses within 1e-3 relative (the level resize
    differs by < 1e-3 grey levels), angles < 1e-3 rad, bits > 0.995."""
    fj, ft = extracted
    vj, vt = np.asarray(fj.valid), ft.valid.numpy()
    assert vj.sum() >= 300
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    np.testing.assert_array_equal(ft.scale.numpy(), np.asarray(fj.scale))
    np.testing.assert_array_equal(ft.uv.numpy()[vj], np.asarray(fj.uv)[vj])
    np.testing.assert_allclose(ft.response.numpy()[vj], np.asarray(fj.response)[vj], rtol=1e-3)
    assert _angle_err(ft.angle.numpy()[vj], np.asarray(fj.angle)[vj]).max() < ANGLE_TOL
    assert (ft.desc.numpy()[vj] == np.asarray(fj.desc)[vj]).mean() > BITS_MIN
    assert len(np.unique(ft.level.numpy()[vt])) >= 3


def test_orb_detections_order_matches_jax(extracted):
    """The response-sorted candidate list: the same order (stable ties)."""
    fj, ft = extracted
    dj, dt = _orb_detections(fj), torb.orb_detections(ft)
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    v = np.asarray(dj.valid)
    np.testing.assert_array_equal(dt.uv.numpy()[v], np.asarray(dj.uv)[v])


@pytest.mark.parametrize("kw", [
    dict(), dict(cross_check=False), dict(max_hamming=256.0, ratio=1.0, cross_check=False),
    dict(max_hamming=80.0, ratio=0.9),
])
def test_match_descriptors_matches_jax(rng, kw):
    """Same +-1 descriptors and masks -> the same indices, distances and
    gates, exactly (integer Hamming sums are exact in float32)."""
    da = np.where(rng.uniform(size=(60, 256)) > 0.5, 1, -1).astype(np.int8)
    db = np.where(rng.uniform(size=(70, 256)) > 0.5, 1, -1).astype(np.int8)
    db[:12] = da[:12]
    db[12:20] = np.where(rng.uniform(size=(8, 256)) < 0.1, -da[12:20], da[12:20])
    db[20] = db[0]                        # a tie: argmin takes the first
    va, vb = rng.uniform(size=60) > 0.1, rng.uniform(size=70) > 0.1
    want = _match_descriptors(jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb), **kw)
    got = torb.match_descriptors(T(da, np.int8), T(va, bool), T(db, np.int8), T(vb, bool), **kw)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.distance.numpy(), np.asarray(want.distance))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert np.asarray(want.ok).sum() >= 5


def _orb_tracker_configs(**kw):
    """The `tests/test_orb.py` tracker config for both packages."""
    base = dict(max_features_per_frame=200, max_nr_keypoints_before_anms=400, feature_detector_type="orb",
                orb_n_levels=3, klt_window=13, klt_levels=2)
    base.update(kw)
    jc = JTrackerConfig(**base)
    return jc, convert.config_from_dict(dataclasses.asdict(jc), tcfg.TrackerConfig)


def _jax_homography_indices(st, f0, f1, cfg, key):
    """The hypothesis indices JAX's tracker draws for its homography RANSAC
    (`tracker.py:176-249` on the CPU: warm-started `klt_track`, bounds,
    background label, then `sample_valid_indices` on the key)."""
    ns = st.s_uv.shape[0]
    fl = j_flow_at(f0.flow, jnp.concatenate([st.s_uv, st.d_uv]), jnp.concatenate([st.s_active, st.d_active]))
    res = j_klt_track(f0.gray, f1.gray, st.s_uv, st.s_active, win=cfg.klt_window,
                      levels=cfg.klt_warm_levels, iters=cfg.klt_warm_iterations, g0=fl[:ns])
    h, w = f1.gray.shape
    u = res.uv
    inb = (u[:, 0] >= cfg.shrink_col) & (u[:, 0] < w - cfg.shrink_col) \
        & (u[:, 1] >= cfg.shrink_row) & (u[:, 1] < h - cfg.shrink_row)
    ok = res.ok & inb & (j_nearest_at(f1.mask, u, st.s_active) == 0) & st.s_active
    return np.asarray(jran.sample_valid_indices(key, ok, 128, 4))


@pytest.fixture(scope="module")
def orb_first_frame(frames):
    """Frame 0 (detection only) through both trackers at the
    `tests/test_orb.py` config; re-association does not act on frame 0,
    so both cases below start from it."""
    jc, tc = _orb_tracker_configs()
    f0 = frames[0]
    jst, jout = j_track_frame(JTrackerState.create(256, 256, 4), f0.gray, f0.gray, f0.flow, f0.mask,
                              jc, key=jax.random.PRNGKey(0), first_frame=True)
    tst, tout = track_frame(convert.tracker_state_from_numpy(JTrackerState.create(256, 256, 4), device="cpu"), T(f0.gray),
                            T(f0.gray), T(f0.flow), T(f0.mask, np.int32), tc, first_frame=True)
    return jst, jout, tst, tout


@pytest.mark.parametrize("reassociate", [False, True])
def test_track_frame_orb_matches_jax(frames, orb_first_frame, reassociate):
    """Two tracking steps in ORB mode at the `tests/test_orb.py` config,
    JAX's homography hypotheses injected.  Frame 0 (detection only): the
    same slots, positions and descriptors exactly.  Frame 1, from JAX's
    state (with re-association: 40 live slots killed and put on cooldown,
    as `test_orb_reassociation_revives_slots`): the same active slots,
    descriptors, new and revived counts, and revived slots; positions
    within 0.05 px (LK with vs without the eps stop)."""
    jc, tc = _orb_tracker_configs(**(dict(orb_reassociate=True, orb_reassoc_max_hamming=80.0,
                                         orb_reassoc_radius_px=60.0) if reassociate else {}))
    f0, f1 = frames[0], frames[1]
    key = jax.random.PRNGKey(0)
    jst, jout, tst, tout = orb_first_frame
    assert int(tout.n_static_new) == int(jout.n_static_new) > 150
    for name in ("s_active", "s_uv", "s_desc", "s_age"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)

    kill = np.where(np.asarray(jst.s_active))[0][:40]
    if reassociate:
        act, cd = np.asarray(jst.s_active).copy(), np.asarray(jst.s_cooldown).copy()
        act[kill], cd[kill] = False, 5
        jst = jst._replace(s_active=jnp.asarray(act), s_cooldown=jnp.asarray(cd))
    idx = _jax_homography_indices(jst, f0, f1, jc, key)
    jst1, jout1 = j_track_frame(jst, f0.gray, f1.gray, f0.flow, f1.mask, jc, key=key, first_frame=False)
    tst1, tout1 = track_frame(convert.tracker_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu"), T(f0.gray),
                              T(f1.gray), T(f0.flow), T(f1.mask, np.int32), tc, first_frame=False,
                              hom_idx=T(idx, np.int64))
    for name in ("n_static_tracked", "n_static_new", "n_reassociated", "homography_inliers"):
        assert int(getattr(tout1, name)) == int(getattr(jout1, name)), name
    ja = np.asarray(jst1.s_active)
    np.testing.assert_array_equal(tst1.s_active.numpy(), ja)
    np.testing.assert_array_equal(tst1.s_desc.numpy(), np.asarray(jst1.s_desc))
    assert np.abs(tst1.s_uv.numpy()[ja] - np.asarray(jst1.s_uv)[ja]).max() < 0.05
    if reassociate:
        assert int(tout1.n_reassociated) >= 5
        np.testing.assert_array_equal(tst1.s_active.numpy()[kill], ja[kill])
        assert tst1.s_active.numpy()[kill].sum() >= 5
    else:
        assert int(tout1.n_reassociated) == 0


@pytest.mark.parametrize("detector", ["harris", "fast"])
def test_track_frame_harris_and_fast_detect_like_jax(frames, detector):
    """The Harris and FAST detector types (the non-ORB branch with their
    response maps): the first frame's detections fill the same slots at
    the same pixels as JAX's."""
    jc, tc = _orb_tracker_configs(feature_detector_type=detector)
    f0 = frames[0]
    jst, jout = j_track_frame(JTrackerState.create(256, 256, 4), f0.gray, f0.gray, f0.flow, f0.mask,
                              jc, key=jax.random.PRNGKey(0), first_frame=True)
    tst, tout = track_frame(convert.tracker_state_from_numpy(JTrackerState.create(256, 256, 4), device="cpu"), T(f0.gray),
                            T(f0.gray), T(f0.flow), T(f0.mask, np.int32), tc, first_frame=True)
    assert int(tout.n_static_new) == int(jout.n_static_new) > 50
    np.testing.assert_array_equal(tst.s_active.numpy(), np.asarray(jst.s_active))
    np.testing.assert_array_equal(tst.s_uv.numpy(), np.asarray(jst.s_uv))
    assert not tst.s_desc.numpy().any()


def test_orb_pipeline_golden_frames_ate():
    """The port's ORB-mode frontend-only pipeline on the first 6 frames of
    the golden scene (2 objects, the golden noise recipe) with the golden
    frontend config: camera ATE (Umeyama-aligned RMSE,
    `dynosam_tpu.eval.metrics.ate`) inside the frontend golden band,
    < 0.010 m, and finite poses on every frame."""
    n = 6
    scene = RenderedScene(RenderConfig(n_frames=n, n_objects=2, seed=0))
    fr = np.random.default_rng(1)
    frames = []
    for f in scene.frames():
        depth = np.asarray(f.depth) * (1.0 + fr.normal(0, 0.01, np.asarray(f.depth).shape).astype(np.float32))
        flow = np.asarray(f.flow) + fr.normal(0, 0.5, np.asarray(f.flow).shape).astype(np.float32)
        frames.append(FrameImages(gray=T(f.gray), depth=T(depth), flow=T(flow), mask=T(f.mask, np.int32)))
    cfg = tcfg.DynoConfig(
        frontend=tcfg.FrontendConfig(
            tracker=tcfg.TrackerConfig(max_features_per_frame=300, klt_window=13, klt_levels=2,
                                       feature_detector_type="orb"),
            min_dynamic_features_per_object=20,
        ),
        capacity=tcfg.CapacityConfig(max_static_tracks=400, max_dynamic_tracks=1024, max_objects=8, max_frames=n),
        pipeline=tcfg.PipelineConfig(use_backend=False),
    )
    pipe = DynoPipeline(convert.camera_from_numpy(scene.cam._asdict()), cfg, device="cpu")
    result = pipe.run(frames)
    est = np.stack([np.eye(4)] * n)
    gt = np.stack([np.eye(4)] * n)
    for k, pkt in enumerate(result.packets):
        est[k, :3, :3], est[k, :3, 3] = pkt.X_world.R.numpy(), pkt.X_world.t.numpy()
        gt[k, :3, :3], gt[k, :3, 3] = np.asarray(scene.X_gt[k].R), np.asarray(scene.X_gt[k].t)
    assert np.isfinite(est).all()
    assert result.frontend_state.tracker.s_desc.abs().sum() > 0
    ate = metrics.ate(est, gt)["trans"].rmse
    print(f"port ORB frontend ATE over {n} golden frames: {ate:.6f} m")
    assert ate < 0.010


def test_kitti_orb_config_is_the_sweep_setting():
    """`kitti_orb_config`: `kitti_config` with the ORB detector; 8 levels at
    1.2, FAST 20/7, 2000 keypoints before the 1000-feature cut, CLAHE on,
    frontend only."""
    cfg = kitti_orb_config()
    tr = cfg.frontend.tracker
    assert (tr.feature_detector_type, tr.orb_n_levels, tr.orb_scale_factor) == ("orb", 8, 1.2)
    assert (tr.orb_init_threshold_fast, tr.orb_min_threshold_fast) == (20, 7)
    assert (tr.max_nr_keypoints_before_anms, tr.max_features_per_frame, tr.use_clahe_filter) == (2000, 1000, True)
    assert (cfg.capacity.max_static_tracks, cfg.capacity.max_dynamic_tracks, cfg.capacity.max_objects) == (2048, 4096, 16)
    assert not cfg.pipeline.use_backend
