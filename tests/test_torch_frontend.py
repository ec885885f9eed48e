"""Port parity for the frontend layer: the renderer (`testing/render.py`),
the state hand-over (`convert.py`), one `track_frame` and one
`frontend_step` started from a state the JAX package carried.

The JAX pipeline runs the first frames of a rendered scene (the golden
noise recipe: 0.5 px flow noise, 1 % depth noise); its state is handed to
the port as numpy leaves and both take the next step on the same images.
RANSAC hypotheses come from different random streams on the two sides, and
the JAX package's CPU tracker runs LK without the eps stop the port (and
the TPU kernel) uses, so the comparisons hold tolerances, stated per test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.frontend.frontend import FrameImages as JFrameImages
from dynosam_tpu.frontend.frontend import frontend_step as j_frontend_step
from dynosam_tpu.frontend.tracker import track_frame as j_track_frame
from dynosam_tpu.pipeline import DynoPipeline as JPipeline
from dynosam_tpu.testing.render import RenderConfig as JRenderConfig
from dynosam_tpu.testing.render import RenderedScene as JRenderedScene
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.frontend.frontend import FrameImages, frontend_step
from dynosam_tpu_torch.frontend.tracker import track_frame
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene

torch.set_num_threads(2)

N_CARRY = 3   # frames the JAX pipeline runs before the hand-over


def small_jax_config():
    """The frontend and capacity parts of the golden accuracy config."""
    return jcfg.DynoConfig(
        frontend=jcfg.FrontendConfig(
            tracker=jcfg.TrackerConfig(max_features_per_frame=300, klt_window=13, klt_levels=2),
            min_dynamic_features_per_object=20,
        ),
        capacity=jcfg.CapacityConfig(max_static_tracks=400, max_dynamic_tracks=1024, max_objects=8),
        pipeline=jcfg.PipelineConfig(use_backend=False),
    )


def to_torch(frame) -> FrameImages:
    return FrameImages(*(torch.as_tensor(np.array(np.asarray(x))) for x in frame))


@pytest.fixture(scope="module")
def carried():
    scene = JRenderedScene(JRenderConfig(n_frames=N_CARRY + 1, n_objects=2, seed=0))
    fr = np.random.default_rng(1)
    frames = [
        JFrameImages(
            gray=f.gray,
            depth=f.depth * (1.0 + jnp.asarray(fr.normal(0, 0.01, f.depth.shape), jnp.float32)),
            flow=f.flow + jnp.asarray(fr.normal(0, 0.5, f.flow.shape), jnp.float32),
            mask=f.mask,
        )
        for f in scene.frames()
    ]
    cfg = small_jax_config()
    pipe = JPipeline(scene.cam, cfg)
    for f in frames[:N_CARRY]:
        pipe.spin_once(f)
    state_np = jax.tree.map(np.asarray, pipe.frontend_state)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return dict(scene=scene, frames=frames, cfg=cfg, tcfg=tcfg, state=pipe.frontend_state,
                state_np=state_np, cam=convert.camera_from_numpy(scene.cam._asdict()))


@pytest.mark.parametrize("kw", [
    dict(n_frames=3, n_objects=2, seed=0),
    dict(n_frames=3, n_objects=3, seed=4, h=96, w=320, fx=180.0, yaw_only_objects=True),
])
def test_renderer_matches_jax(kw):
    """Same seed -> the same frames: masks exactly; grey levels within 1e-2
    (of 20..220), depth 1e-4 m, flow 1e-3 px (f32 ray casting in another
    association order); the same ground-truth poses to 1e-5 (f32 exponential maps)."""
    js = JRenderedScene(JRenderConfig(**kw))
    ps = RenderedScene(RenderConfig(**kw), device="cpu")
    for a, b in zip(js.frames(), ps.frames()):
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_allclose(b.gray.numpy(), np.asarray(a.gray), atol=1e-2)
        np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth), atol=1e-4)
        np.testing.assert_allclose(b.flow.numpy(), np.asarray(a.flow), atol=1e-3)
    for Xj, Xt in zip(js.X_gt, ps.X_gt):
        np.testing.assert_allclose(Xt.R.numpy(), np.asarray(Xj.R), atol=1e-6)
        np.testing.assert_allclose(Xt.t.numpy(), np.asarray(Xj.t), atol=1e-5)
    for o in range(kw["n_objects"]):
        np.testing.assert_allclose(ps.object_pose_at(2, o).t.numpy(), np.asarray(js.object_pose_at(2, o).t), atol=1e-5)
    assert ps.object_labels == js.object_labels


def test_load_config_matches_jax(tmp_path):
    """The port's copy of `load_config`: YAML groups plus dotted overrides
    give the same config as the JAX package's."""
    from dynosam_tpu_torch.utils.config import load_config

    path = tmp_path / "cfg.yaml"
    path.write_text("frontend:\n  tracker:\n    klt_window: 15\n  max_active_objects: 4\n"
                    "pipeline:\n  use_backend: false\n")
    over = {"capacity.max_objects": 12, "frontend.tracker.max_features_per_frame": 500}
    want = dataclasses.asdict(jcfg.load_config(str(path), over))
    got = dataclasses.asdict(load_config(str(path), over))
    assert got == want
    assert got["frontend"]["tracker"]["klt_window"] == 15 and got["capacity"]["max_objects"] == 12


def test_convert_round_trip(carried):
    """Config, camera and a carried state survive the hand-over unchanged,
    int32 state dtypes included."""
    assert dataclasses.asdict(carried["tcfg"]) == dataclasses.asdict(carried["cfg"])
    st = convert.frontend_state_from_numpy(carried["state_np"])
    back = convert.frontend_output_to_numpy(st)
    src = carried["state_np"]
    for name in ("s_uv", "s_active", "s_age", "d_obj", "obj_labels"):
        a, b = getattr(src.tracker, name), getattr(back.tracker, name)
        np.testing.assert_array_equal(b, a)
        assert b.dtype == a.dtype
    np.testing.assert_array_equal(back.X_world.R, src.X_world.R)
    np.testing.assert_array_equal(back.d_lmk, src.d_lmk)
    assert int(back.frame_idx) == N_CARRY
    cam = carried["cam"]
    assert (cam.fx, cam.cy, cam.width) == (float(carried["scene"].cam.fx), float(carried["scene"].cam.cy), 160)


def test_track_frame_from_jax_state(carried):
    """One tracking step from the JAX-carried tracker state: static slots
    agree on >= 98 % (LK without vs with the eps stop, homography RANSAC
    from other draws), tracked positions within 0.05 px where both track;
    the dynamic pool and the object table exactly."""
    frames, k = carried["frames"], N_CARRY
    tc = carried["cfg"].frontend.tracker
    jst, jrep = j_track_frame(
        carried["state"].tracker, frames[k - 1].gray, frames[k].gray, frames[k - 1].flow, frames[k].mask,
        tc, use_klt=True, first_frame=False, key=jax.random.PRNGKey(5),
    )
    tst, trep = track_frame(
        convert.tracker_state_from_numpy(carried["state_np"].tracker), to_torch(frames[k - 1]).gray,
        to_torch(frames[k]).gray, to_torch(frames[k - 1]).flow, to_torch(frames[k]).mask,
        carried["tcfg"].frontend.tracker, use_klt=True, first_frame=False,
        generator=torch.Generator().manual_seed(5),
    )
    ja, ta = np.asarray(jst.s_active), tst.s_active.numpy()
    assert (ja == ta).mean() >= 0.98
    both = ja & ta & (np.asarray(jst.s_age) > 0) & (tst.s_age.numpy() > 0)
    assert both.sum() >= 100
    d = np.linalg.norm(np.asarray(jst.s_uv)[both] - tst.s_uv.numpy()[both], axis=1)
    assert d.max() < 0.05
    np.testing.assert_array_equal(tst.d_active.numpy(), np.asarray(jst.d_active))
    np.testing.assert_array_equal(tst.d_obj.numpy(), np.asarray(jst.d_obj))
    np.testing.assert_allclose(tst.d_uv.numpy(), np.asarray(jst.d_uv), atol=1e-4)
    np.testing.assert_array_equal(tst.obj_labels.numpy(), np.asarray(jst.obj_labels))
    np.testing.assert_array_equal(tst.obj_active.numpy(), np.asarray(jst.obj_active))
    assert int(trep.n_dynamic_tracked) == int(jrep.n_dynamic_tracked)
    assert abs(int(trep.n_static_tracked) - int(jrep.n_static_tracked)) <= 0.02 * int(jrep.n_static_tracked)


def test_frontend_step_from_jax_state(carried):
    """One whole frontend step (3d2d ego PnP, object RANSAC, fused joint
    refinement, motion-only refinement, pose propagation) from the JAX-
    carried state: camera pose within 2e-3 m / 2e-4 (rotation entries),
    the same objects with a valid motion, their motions within 1e-2 m /
    2e-3; static observations agree on >= 97 % of slots.  Tracked features
    keep their slots: where both sides hold one, positions agree within
    0.1 px on >= 99 % of them and their 3D points within 1 cm.  Fresh
    detections may fill the free slots in another order (a slot freed on
    one side only shifts them, and a budget one track apart takes one
    detection more or less), so >= 75 % of them are the same pixels."""
    frames, k = carried["frames"], N_CARRY
    jst, jpkt, _, _ = j_frontend_step(
        carried["state"], frames[k - 1], frames[k], carried["scene"].cam, carried["cfg"].frontend,
        jax.random.PRNGKey(k), use_klt=True, first_frame=False,
    )
    tst, tpkt, _, _ = frontend_step(
        convert.frontend_state_from_numpy(carried["state_np"]), to_torch(frames[k - 1]), to_torch(frames[k]),
        carried["cam"], carried["tcfg"].frontend, generator=torch.Generator().manual_seed(k),
        use_klt=True, first_frame=False, device="cpu",
    )
    j, t = jax.tree.map(np.asarray, jpkt), convert.frontend_output_to_numpy(tpkt)
    np.testing.assert_allclose(t.X_world.t, j.X_world.t, atol=2e-3)
    np.testing.assert_allclose(t.X_world.R, j.X_world.R, atol=2e-4)
    np.testing.assert_array_equal(t.objects.motion_valid, j.objects.motion_valid)
    assert j.objects.motion_valid.sum() >= 1
    mv = j.objects.motion_valid
    np.testing.assert_allclose(t.objects.motion.t[mv], j.objects.motion.t[mv], atol=1e-2)
    np.testing.assert_allclose(t.objects.motion.R[mv], j.objects.motion.R[mv], atol=2e-3)
    np.testing.assert_array_equal(t.objects.label, j.objects.label)
    assert (t.static_obs.valid == j.static_obs.valid).mean() >= 0.97
    t_age, j_age = tst.tracker.s_age.numpy(), np.asarray(jst.tracker.s_age)
    tracked = t.static_obs.valid & j.static_obs.valid & (t_age > 0) & (j_age > 0)
    same = tracked & (np.linalg.norm(t.static_obs.uv - j.static_obs.uv, axis=1) < 0.1)
    assert same.sum() >= 0.99 * tracked.sum()
    assert np.abs(t.static_obs.xyz[same] - j.static_obs.xyz[same]).max() < 0.01
    fresh_t = {tuple(x) for x in t.static_obs.uv[t.static_obs.valid & (t_age == 0)].tolist()}
    fresh_j = {tuple(x) for x in j.static_obs.uv[j.static_obs.valid & (j_age == 0)].tolist()}
    assert len(fresh_t & fresh_j) >= 0.75 * len(fresh_j)
    assert int(tst.frame_idx) == int(np.asarray(jst.frame_idx)) == k + 1
