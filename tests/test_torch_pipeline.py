"""The port's frontend-only slice as a whole, and the guards around it.

* The slice: `DynoPipeline(use_backend=False, device="cpu")` of the port on
  the golden 32-frame scene (2 moving objects, 0.5 px flow noise and 1 %
  depth noise) with the frontend and capacity parts of the golden config
  (`tests/test_accuracy_regression.py`) must pass the frontend golden bands,
  evaluated by the JAX package's own logger and evaluator
  (`dynosam_tpu.eval.metrics` underneath).
* Guards: the port imports neither JAX nor the JAX package, its entry
  points refuse to fall back to the CPU, options outside the slice raise,
  and a CPU run launches no kernel.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.eval.evaluator import evaluate_all
from dynosam_tpu.testing.render import RenderConfig, RenderedScene
from dynosam_tpu.utils.logger import EstimationLogger
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.frontend.frontend import FrameImages
from dynosam_tpu_torch.pipeline import DynoPipeline
from dynosam_tpu_torch.utils import config as tcfg

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N_FRAMES = 32


def golden_frontend_config(**tracker_kw):
    """Frontend and capacity parts of `test_accuracy_regression._make_cfg`."""
    return tcfg.DynoConfig(
        frontend=tcfg.FrontendConfig(
            tracker=tcfg.TrackerConfig(max_features_per_frame=300, klt_window=13, klt_levels=2, **tracker_kw),
            min_dynamic_features_per_object=20,
        ),
        capacity=tcfg.CapacityConfig(max_static_tracks=400, max_dynamic_tracks=1024,
                                     max_objects=8, max_frames=N_FRAMES),
        pipeline=tcfg.PipelineConfig(use_backend=False),
    )


def _mat(R, t):
    T = np.eye(4)
    T[:3, :3] = np.asarray(R)
    T[:3, 3] = np.asarray(t)
    return T


def test_golden_frontend_bands(tmp_path):
    """ATE < 0.010 m, RPE < 0.004 m and 0.03 deg, AME < 0.30 m and 3.0 deg,
    RME < 0.08 m: the bands of `test_golden_frontend_bands`."""
    scene = RenderedScene(RenderConfig(n_frames=N_FRAMES, n_objects=2, seed=0))
    fr = np.random.default_rng(1)           # the golden noise recipe, in order
    frames = [
        FrameImages(
            gray=torch.as_tensor(np.array(f.gray)),
            depth=torch.as_tensor(np.array(f.depth * (1.0 + jnp.asarray(
                fr.normal(0, 0.01, np.asarray(f.depth).shape), jnp.float32)))),
            flow=torch.as_tensor(np.array(f.flow + jnp.asarray(
                fr.normal(0, 0.5, np.asarray(f.flow).shape), jnp.float32))),
            mask=torch.as_tensor(np.array(f.mask)),
        )
        for f in scene.frames()
    ]
    pipe = DynoPipeline(convert.camera_from_numpy(scene.cam._asdict()), golden_frontend_config(), device="cpu")
    result = pipe.run(frames)
    assert len(result.packets) == N_FRAMES

    log = EstimationLogger(str(tmp_path), "frontend")
    for k, pkt in enumerate(result.packets):
        p = convert.frontend_output_to_numpy(pkt)
        log.log_camera_pose(k, _mat(p.X_world.R, p.X_world.t), _mat(scene.X_gt[k].R, scene.X_gt[k].t))
        log.log_timestamp(k, float(p.timestamp))
        for j in np.nonzero(p.objects.motion_valid)[0]:
            o = scene.object_labels.index(int(p.objects.label[j]))
            log.log_object_motion(k, int(p.objects.label[j]), _mat(p.objects.motion.R[j], p.objects.motion.t[j]),
                                  _mat(scene.H_gt_list[o].R, scene.H_gt_list[o].t))
            L = scene.object_pose_at(k, o)
            log.log_object_pose(k, int(p.objects.label[j]), _mat(p.objects.pose.R[j], p.objects.pose.t[j]),
                                _mat(L.R, L.t))
    log.flush()
    ev = evaluate_all(str(tmp_path))["frontend"]
    cam = ev["camera"]
    assert cam["n_frames"] == N_FRAMES
    assert cam["ate_trans_rmse"] < 0.010, cam
    assert cam["rpe_trans_rmse"] < 0.004, cam
    assert cam["rpe_rot_deg_rmse"] < 0.03, cam
    objs = ev["objects_mean"]
    assert len(ev["objects"]) == 2, ev["objects"]
    assert objs["ame_trans_rmse"] < 0.30, objs
    assert objs["ame_rot_deg_rmse"] < 3.0, objs
    assert objs["rme_trans_rmse"] < 0.08, objs


def test_port_imports_no_jax_and_cpu_run_launches_no_kernel():
    """A fresh interpreter (isolated from any site hook) imports the port,
    renders two small frames and runs the pipeline on the CPU: no `jax` and
    no `dynosam_tpu.*` module gets imported, and no kernel launches."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from dynosam_tpu_torch import kernels
from dynosam_tpu_torch.pipeline import DynoPipeline
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch.utils.config import DynoConfig, PipelineConfig, CapacityConfig
scene = RenderedScene(RenderConfig(n_frames=2, h=48, w=64, fx=48.0), device="cpu")
cfg = DynoConfig(pipeline=PipelineConfig(use_backend=False),
                 capacity=CapacityConfig(max_static_tracks=64, max_dynamic_tracks=128, max_objects=4))
pipe = DynoPipeline(scene.cam, cfg, device="cpu")
kernels.reset_launch_counts()
for f in scene.frames():
    pkt = pipe.spin_once(f)
assert torch.isfinite(pkt.X_world.t).all()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "dynosam_tpu.")) or m == "dynosam_tpu")
print("BAD", bad)
print("COUNTS", kernels.launch_counts())
"""
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "COUNTS {'lk': 0, 'point_sample': 0, 'response': 0}" in out.stdout, out.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|dynosam_tpu)(?:\.|\s|$)", re.M)


def test_source_scan_finds_no_jax_imports():
    """No module of the port and not `chip_smoke.py` imports JAX or the JAX
    package (`dynosam_tpu_torch` itself does not match the pattern)."""
    files = sorted((ROOT / "dynosam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip()) for f in files
            for m in _IMPORT.finditer(f.read_text())]
    assert hits == []
    for f in files:
        text = f.read_text()
        assert "__import__(\"jax" not in text and "import_module(\"jax" not in text, f


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without `device="cpu"` the entry points ask for CUDA and raise when
    no card is present; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = golden_frontend_config()
    cam = convert.camera_from_numpy(dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynoPipeline(cam, cfg)
    from dynosam_tpu_torch.testing.render import RenderedScene as TScene
    from dynosam_tpu_torch.testing.render import RenderConfig as TRenderConfig

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TScene(TRenderConfig(n_frames=1))


@pytest.mark.parametrize("option", [
    "orb", "harris", "fast", "3d3d", "2d2d", "legacy_3d3d", "propagate_mask", "byte_tracker", "backend",
])
def test_options_outside_the_slice_raise(option):
    """Each option the slice does not port raises NotImplementedError that
    names the ROADMAP.md item porting it, before any work runs."""
    cfg = golden_frontend_config()
    fe, tr = cfg.frontend, cfg.frontend.tracker
    if option in ("orb", "harris", "fast"):
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            fe, tracker=dataclasses.replace(tr, feature_detector_type=option)))
    elif option in ("3d3d", "2d2d"):
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(fe, ego_motion_solver=option))
    elif option == "legacy_3d3d":
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(fe, use_ego_motion_pnp=False))
    elif option == "propagate_mask":
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            fe, tracker=dataclasses.replace(tr, use_propogate_mask=True)))
    elif option == "byte_tracker":
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            fe, tracker=dataclasses.replace(tr, use_byte_tracker=True)))
    else:
        cfg = dataclasses.replace(cfg, pipeline=tcfg.PipelineConfig(use_backend=True))
    cam = convert.camera_from_numpy(dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md item"):
        DynoPipeline(cam, cfg, device="cpu")
