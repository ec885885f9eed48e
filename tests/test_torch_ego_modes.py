"""Port parity for the alternate ego-motion modes of `frontend_step`: 3d3d
(Arun RANSAC on camera-frame against world points), 2d2d (8-point essential
RANSAC with metric scale from the previous frame's depth), 2d2d with the
2-point solver under the constant-velocity rotation prior, and the legacy
alias `use_ego_motion_pnp=False` (= 3d3d).

As `tests/test_torch_frontend.py` does for the 3d2d mode: the JAX pipeline
runs the first frames of the golden scene (0.5 px flow, 1 % depth noise)
in the 3d3d mode, its state is handed to the port, and both take the next
step on the same images in each mode.  RANSAC hypotheses come from different random streams on the two
sides, so the step's camera pose is held within a tolerance stated per mode
(`TOL`, beside the spreads measured); the alias equals 3d3d bit for bit on
the port's side.

The 2-point mode carries its rotation prior from frame to frame, so it is
also held over a run: JAX's 2-point run from frame 0, and the port's run
from JAX's state after frame 1 (whose 8-point step sets the prior), frame
by frame (`test_two_point_run_from_jax_state`).  Run as a script, this file
makes the same comparison on the 12-frame KITTI-width scene of the smoke
run's ego phase (1280x384, `kitti_config`), with the port's own run from
frame 0 beside it:

    PYTHONPATH=. python tests/test_torch_ego_modes.py
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.frontend.frontend import FrameImages as JFrameImages
from dynosam_tpu.frontend.frontend import frontend_step as j_frontend_step
from dynosam_tpu.pipeline import DynoPipeline as JPipeline
from dynosam_tpu.testing.render import RenderConfig as JRenderConfig
from dynosam_tpu.testing.render import RenderedScene as JRenderedScene
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.frontend.frontend import FrameImages, frontend_step
from dynosam_tpu_torch.pipeline import DynoPipeline

torch.set_num_threads(2)

N_CARRY = 3
MODES = {
    "3d3d": dict(ego_motion_solver="3d3d"),
    "2d2d": dict(ego_motion_solver="2d2d"),
    "2d2d_2point": dict(ego_motion_solver="2d2d", two_point=True),
}
# camera position (m) and rotation entries against the JAX step; measured
# (CPU, 2 threads): 3d3d 1.3e-4 m / 2.4e-5, 2d2d 1.1e-4 m / 1.5e-5, 2-point
# 2.0e-4 m / 1.9e-5, from the two sides' different RANSAC draws
TOL = {"3d3d": (1e-3, 2e-4), "2d2d": (1e-3, 2e-4), "2d2d_2point": (1e-3, 2e-4)}


def _config(mode: str):
    """The frontend and capacity parts of the golden accuracy config, in
    the ego mode."""
    kw = dict(MODES.get(mode, {}))
    two_point = kw.pop("two_point", False)
    return jcfg.DynoConfig(
        frontend=jcfg.FrontendConfig(
            tracker=jcfg.TrackerConfig(max_features_per_frame=300, klt_window=13, klt_levels=2),
            min_dynamic_features_per_object=20,
            camera_solver=jcfg.MotionSolverConfig(ransac_use_2point_mono=two_point),
            **kw,
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
    # carried in the 3d3d mode, whose compiled step the 3d3d case reuses
    pipe = JPipeline(scene.cam, _config("3d3d"))
    for f in frames[:N_CARRY]:
        pipe.spin_once(f)
    return dict(scene=scene, frames=frames, state=pipe.frontend_state,
                state_np=jax.tree.map(np.asarray, pipe.frontend_state),
                cam=convert.camera_from_numpy(scene.cam._asdict()), jax_steps={})


def _jax_step(carried, mode):
    if mode not in carried["jax_steps"]:
        frames, k = carried["frames"], N_CARRY
        _, jpkt, _, jego = j_frontend_step(
            carried["state"], frames[k - 1], frames[k], carried["scene"].cam, _config(mode).frontend,
            jax.random.PRNGKey(k), use_klt=True, first_frame=False,
        )
        carried["jax_steps"][mode] = (jax.tree.map(np.asarray, jpkt), jax.tree.map(np.asarray, jego))
    return carried["jax_steps"][mode]


def _torch_step(carried, cfg):
    frames, k = carried["frames"], N_CARRY
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    _, tpkt, _, tego = frontend_step(
        convert.frontend_state_from_numpy(carried["state_np"], device="cpu"), to_torch(frames[k - 1]),
        to_torch(frames[k]), carried["cam"], tcfg.frontend, generator=torch.Generator().manual_seed(k),
        use_klt=True, first_frame=False, device="cpu",
    )
    return convert.frontend_output_to_numpy(tpkt), tego


@pytest.mark.parametrize("mode", ["3d3d", "2d2d", "2d2d_2point", "legacy_3d3d"])
def test_ego_mode_step_from_jax_state(carried, mode):
    """One frontend step in the mode from the JAX-carried state: the ego
    solve is valid on both sides and the camera pose agrees within TOL;
    the 2-point case runs with the rotation prior (rel_prev_valid)."""
    jmode = "3d3d" if mode == "legacy_3d3d" else mode
    cfg = _config(jmode)
    if mode == "legacy_3d3d":
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, ego_motion_solver="3d2d",
                                                                    use_ego_motion_pnp=False))
    jpkt, jego = _jax_step(carried, jmode)
    t, tego = _torch_step(carried, cfg)
    if jmode == "2d2d_2point":
        assert bool(carried["state_np"].rel_prev_valid)
    assert int(jego.status) == 0 and int(tego.status) == 0
    atol_t, atol_R = TOL[jmode]
    np.testing.assert_allclose(t.X_world.t, jpkt.X_world.t, atol=atol_t)
    np.testing.assert_allclose(t.X_world.R, jpkt.X_world.R, atol=atol_R)
    gt = carried["scene"].X_gt[N_CARRY]
    assert np.linalg.norm(t.X_world.t - np.asarray(gt.t)) < 0.02
    if mode == "legacy_3d3d":
        t3, _ = _torch_step(carried, _config("3d3d"))
        np.testing.assert_array_equal(t.X_world.t, t3.X_world.t)
        np.testing.assert_array_equal(t.X_world.R, t3.X_world.R)


N_RUN = 7
# per-frame camera position (m) and rotation entries of the port's 2-point
# run against JAX's: one step's tolerance, as the spread does not grow over
# the run; measured (CPU, 2 threads) 2.0e-5, 2.3e-4, 2.4e-4, 3.0e-4, 2.6e-4 m
# and at most 3.0e-5 on frames 2-6 (the two sides' RANSAC draws)
RUN_TOL = TOL["2d2d_2point"]


def _noisy_frames(scene, seed: int):
    fr = np.random.default_rng(seed)
    return [JFrameImages(gray=f.gray, depth=f.depth * (1.0 + jnp.asarray(fr.normal(0, 0.01, f.depth.shape), jnp.float32)),
                         flow=f.flow + jnp.asarray(fr.normal(0, 0.5, f.flow.shape), jnp.float32), mask=f.mask)
            for f in scene.frames()]


def two_point_runs(scene, frames, cfg, free_run: bool = False):
    """Per-frame camera (t, R) of JAX's 2-point pipeline run, of the port's
    run from JAX's state after frame 1, and with `free_run` of the port's
    own run from frame 0 (None otherwise)."""
    jp = JPipeline(scene.cam, cfg)
    jt, jR, state1 = [], [], None
    for k, f in enumerate(frames):
        pk = jp.spin_once(f)
        jt.append(np.asarray(pk.X_world.t))
        jR.append(np.asarray(pk.X_world.R))
        if k == 1:
            state1 = jax.tree.map(np.asarray, jp.frontend_state)
    assert bool(state1.rel_prev_valid)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    cam = convert.camera_from_numpy(scene.cam._asdict())
    tframes = [to_torch(f) for f in frames]
    tp = DynoPipeline(cam, tcfg, device="cpu")
    tp.frontend_state = convert.frontend_state_from_numpy(state1, device="cpu")
    tp._prev_images, tp._k = tframes[1], 2
    pks = [tp.spin_once(f) for f in tframes[2:]]
    tt = jt[:2] + [p.X_world.t.numpy() for p in pks]
    tR = jR[:2] + [p.X_world.R.numpy() for p in pks]
    free = None
    if free_run:
        fp = DynoPipeline(cam, tcfg, device="cpu")
        free = np.stack([fp.spin_once(f).X_world.t.numpy() for f in tframes])
    return np.stack(jt), np.stack(jR), np.stack(tt), np.stack(tR), free


def test_two_point_run_from_jax_state():
    """The 2-point mode over N_RUN frames: the port's run from JAX's state
    after frame 1 stays on JAX's trajectory frame by frame within RUN_TOL
    (a fault in the carried prior or the translation solve would grow)."""
    scene = JRenderedScene(JRenderConfig(n_frames=N_RUN, n_objects=2, seed=0))
    jt, jR, tt, tR, _ = two_point_runs(scene, _noisy_frames(scene, 1), _config("2d2d_2point"))
    np.testing.assert_allclose(tt, jt, atol=RUN_TOL[0])
    np.testing.assert_allclose(tR, jR, atol=RUN_TOL[1])
    gt = np.stack([np.asarray(x.t) for x in scene.X_gt])
    assert np.linalg.norm(tt - gt, axis=1).max() < 0.02


def _kitti_width_comparison():
    """The 2-point runs on the smoke run's 12-frame KITTI-width scene
    (`testing/scenes.py:kitti_scene`, `kitti_config`); prints each run's
    camera ATE and per-frame position error, and the port's distance from
    JAX's trajectory."""
    scene = JRenderedScene(JRenderConfig(n_frames=12, h=384, w=1280, fx=718.0, n_objects=3, bg_depth=14.0,
                                         obj_depth=9.0, cam_step=0.10, obj_step=0.18))
    fr = np.random.default_rng(0)
    frames = [f._replace(flow=f.flow + jnp.asarray(fr.normal(0.0, 0.5, f.flow.shape).astype(np.float32)))
              for f in scene.frames()]
    cfg = jcfg.DynoConfig(
        frontend=jcfg.FrontendConfig(tracker=jcfg.TrackerConfig(max_features_per_frame=1000),
                                     ego_motion_solver="2d2d",
                                     camera_solver=jcfg.MotionSolverConfig(ransac_use_2point_mono=True)),
        capacity=jcfg.CapacityConfig(max_static_tracks=2048, max_dynamic_tracks=4096, max_objects=16),
        pipeline=jcfg.PipelineConfig(use_backend=False),
    )
    jt, jR, tt, tR, free = two_point_runs(scene, frames, cfg, free_run=True)
    gt = np.stack([np.asarray(x.t, np.float64) for x in scene.X_gt])
    np.set_printoptions(precision=7, linewidth=160)
    for name, t in (("JAX", jt), ("port from JAX's frame-1 state", tt), ("port from frame 0", free)):
        err = np.linalg.norm(t - gt, axis=1)
        print(f"{name}: camera ATE {np.sqrt(np.mean(err ** 2)):.7f} m; per-frame position error (m) {err}")
    print(f"port from JAX's frame-1 state against JAX: position (m) {np.linalg.norm(tt - jt, axis=1)}; "
          f"rotation entries {np.abs(tR - jR).reshape(len(jt), -1).max(1)}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _kitti_width_comparison()
