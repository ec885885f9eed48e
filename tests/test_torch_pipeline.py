"""The port's online pipeline as a whole, and the guards around it.

* The slice: the port's `run_and_log` (`DynoPipeline` with the full-batch
  `RGBDBackend`, `device="cpu"`) on the golden 32-frame scene of
  `tests/test_accuracy_regression.py` (2 moving objects, 0.5 px flow noise
  and 1 % depth noise, the JAX renderer's frames) with the golden config,
  evaluated by the port's own `evaluate_all`: the frontend bands
  (`:123-134`), the backend bands with the object improvement
  (`:137-152`) and the sliding-vs-batch ordering (`:155-163`, the sliding
  run through the port's `run_from_packets`).
* Guards: the port imports neither JAX nor the JAX package (nor `cv2`),
  its entry points refuse to fall back to the CPU, and a CPU run launches
  no kernel.  (The alternate frontend options have their parity tests in
  `tests/test_torch_{ego_modes,mask_ops,byte_tracker}.py`.)
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.data.base import DatasetProvider, GroundTruthFrame
from dynosam_tpu_torch.eval import metrics
from dynosam_tpu_torch.eval.evaluator import evaluate_all
from dynosam_tpu_torch.frontend.frontend import FrameImages
from dynosam_tpu_torch.pipeline import DynoPipeline, run_and_log, run_from_packets
from dynosam_tpu_torch.testing.scenes import RenderedDataset, golden_config
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


class JaxSceneDataset(DatasetProvider):
    """The JAX renderer's golden frames (noise added, as torch tensors) with
    the scene's ground truth."""

    def __init__(self, scene, frames):
        super().__init__("<golden>")
        self.scene, self._frames = scene, frames

    def __len__(self):
        return len(self._frames)

    def camera_params(self):
        return convert.camera_from_numpy(self.scene.cam._asdict())

    def frame(self, idx):
        return self._frames[idx]

    def ground_truth(self, idx):
        sc = self.scene
        return GroundTruthFrame(
            frame_id=idx, timestamp=idx * 0.1, X_world=_mat(sc.X_gt[idx].R, sc.X_gt[idx].t),
            object_poses={lab: _mat(sc.object_pose_at(idx, o).R, sc.object_pose_at(idx, o).t)
                          for o, lab in enumerate(sc.object_labels)},
            object_motions={lab: _mat(sc.H_gt_list[o].R, sc.H_gt_list[o].t)
                            for o, lab in enumerate(sc.object_labels)})


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """`test_accuracy_regression.golden_run` on the port: the golden frames
    through the port's `run_and_log` (full batch) and `evaluate_all`."""
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
    out = tmp_path_factory.mktemp("golden")
    result = run_and_log(JaxSceneDataset(scene, frames), golden_config(True), str(out), device="cpu")
    gt_T = np.stack([_mat(X.R, X.t) for X in scene.X_gt])
    return result, evaluate_all(str(out)), gt_T


def _backend_ate(be, gt_T):
    X, xv = be.camera_poses()
    xv = xv.numpy()
    T = np.stack([_mat(R, t) for R, t in zip(X.R.numpy()[xv], X.t.numpy()[xv])])
    return metrics.ate(T, gt_T[xv])["trans"].rmse


def test_golden_frontend_bands(golden_run):
    """ATE < 0.010 m, RPE < 0.004 m and 0.03 deg, AME < 0.30 m and 3.0 deg,
    RME < 0.08 m: the bands of `test_golden_frontend_bands`."""
    result, evals, _ = golden_run
    assert len(result.packets) == N_FRAMES
    ev = evals["frontend"]
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


def test_golden_backend_bands_and_object_improvement(golden_run):
    """Backend camera ATE < 0.022 m, object AME < 0.15 m, and both AME
    parts below 0.8x the frontend's (`:137-152`); the full-batch solve is
    one LM-PCG over all 32 frames."""
    result, evals, _ = golden_run
    solves = result.backend.solves
    assert [(s, w) for s, w, _, _ in solves] == [(0, N_FRAMES)]
    r = solves[0][2]
    assert float(r.error) < float(r.initial_error) and len(r.cg_iterations) == r.iterations
    be = evals["rgbd_motion_world_backend"]
    assert be["camera"]["n_frames"] == N_FRAMES
    assert be["camera"]["ate_trans_rmse"] < 0.022, be["camera"]
    objs_be, objs_fe = be["objects_mean"], evals["frontend"]["objects_mean"]
    assert objs_be["ame_trans_rmse"] < 0.15, objs_be
    assert objs_be["ame_trans_rmse"] < 0.8 * objs_fe["ame_trans_rmse"], (objs_be, objs_fe)
    assert objs_be["ame_rot_deg_rmse"] < 0.8 * objs_fe["ame_rot_deg_rmse"], (objs_be, objs_fe)


def test_sliding_vs_batch_ordering(golden_run):
    """Sliding windows (10/4) through `run_from_packets`: ATE < 0.06 m, and
    the full batch no worse than 1.10x it (`:155-163`)."""
    result, evals, gt_T = golden_run
    be_sw = run_from_packets(result.packets, golden_config(False), device="cpu")
    assert [(s, w) for s, w, _, _ in be_sw.solves] == [(0, 10), (6, 10), (12, 10), (18, 10), (24, 8)]
    sw_ate = _backend_ate(be_sw, gt_T)
    fb_ate = evals["rgbd_motion_world_backend"]["camera"]["ate_trans_rmse"]
    assert sw_ate < 0.06, sw_ate
    assert fb_ate <= sw_ate * 1.10, (fb_ate, sw_ate)


def test_port_imports_no_jax_and_cpu_run_launches_no_kernel():
    """A fresh interpreter (isolated from any site hook) imports the port
    (the CLI, every loader, the evaluator, serialisation and the alternate
    frontend modules included),
    renders two small frames and runs the pipeline on the CPU with the
    Shi-Tomasi and with the ORB detector: no `jax`, no `dynosam_tpu.*`, no
    `cv2` and no `matplotlib` module gets imported (the parallel layer, the
    debug, histogram, viz and plotting tools, the evaluation tools of
    `scripts/` and the tracer imported too), and no kernel launches."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from dynosam_tpu_torch import kernels
import dynosam_tpu_torch.__main__, dynosam_tpu_torch.data.factory, dynosam_tpu_torch.eval.evaluator
import dynosam_tpu_torch.utils.serialization
import dynosam_tpu_torch.data.vkitti, dynosam_tpu_torch.data.cluster, dynosam_tpu_torch.data.omd
import dynosam_tpu_torch.data.aria, dynosam_tpu_torch.data.native_loader, dynosam_tpu_torch.frontend.rectify
import dynosam_tpu_torch.frontend.stereo, dynosam_tpu_torch.frontend.byte_tracker, dynosam_tpu_torch.frontend.imu
import dynosam_tpu_torch.ops.epipolar, dynosam_tpu_torch.core.distortion
import dynosam_tpu_torch.parallel.mesh, dynosam_tpu_torch.parallel.multihost, dynosam_tpu_torch.parallel.schur_dist
import dynosam_tpu_torch.parallel.distributed_ba, dynosam_tpu_torch.parallel.batch_eval
import dynosam_tpu_torch.parallel.mp_worker, dynosam_tpu_torch.utils.debug, dynosam_tpu_torch.utils.histogram
import dynosam_tpu_torch.viz.visualizer, dynosam_tpu_torch.eval.plotting
import dynosam_tpu_torch.scripts.run_experiments, dynosam_tpu_torch.scripts.experiment_sweep
import dynosam_tpu_torch.scripts.sliding_vs_batch, dynosam_tpu_torch.scripts.ab_accuracy
import dynosam_tpu_torch.scripts.run_cli_demo, dynosam_tpu_torch.scripts.kitti_semantic_to_motion
import dynosam_tpu_torch.testing.trace
from dynosam_tpu_torch.pipeline import DynoPipeline, run_and_log, run_from_packets
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch.testing.scenes import RenderedDataset
from dynosam_tpu_torch.utils.config import DynoConfig, FrontendConfig, PipelineConfig, CapacityConfig, TrackerConfig
scene = RenderedScene(RenderConfig(n_frames=2, h=48, w=64, fx=48.0), device="cpu")
kernels.reset_launch_counts()
for detector in ("shi_tomasi", "orb"):
    cfg = DynoConfig(pipeline=PipelineConfig(use_backend=False),
                     frontend=FrontendConfig(tracker=TrackerConfig(feature_detector_type=detector)),
                     capacity=CapacityConfig(max_static_tracks=64, max_dynamic_tracks=128, max_objects=4))
    pipe = DynoPipeline(scene.cam, cfg, device="cpu")
    for f in scene.frames():
        pkt = pipe.spin_once(f)
    assert torch.isfinite(pkt.X_world.t).all()
bad = sorted(m for m in sys.modules if m in ("jax", "dynosam_tpu", "cv2", "matplotlib")
             or m.startswith(("jax.", "jaxlib", "dynosam_tpu.", "matplotlib.")))
print("BAD", bad)
print("COUNTS", kernels.launch_counts())
"""
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert ("COUNTS {'lk': 0, 'point_sample': 0, 'response': 0, 'orb_sample': 0, 'refine': 0, 'ransac': 0, "
            "'window_build': 0, 'window_step': 0, 'window_update': 0}" in out.stdout), out.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|dynosam_tpu)(?:\.|\s|$)", re.M)
# cv2 and matplotlib only inside the functions that draw or decode with them
_TOP_LEVEL_HOST_LIB = re.compile(r"^(?:import|from)\s+(cv2|matplotlib)(?:\.|\s|$)", re.M)


def test_source_scan_finds_no_jax_imports():
    """No module of the port, of its benchmark (`bench_torch/`) and not
    `chip_smoke.py` imports JAX or the JAX package (`dynosam_tpu_torch`
    itself does not match the pattern), nor `cv2` or `matplotlib` at
    module level; the parallel layer, the tools and the evaluation tools of
    `scripts/` are among the files scanned."""
    port = sorted((ROOT / "dynosam_tpu_torch").rglob("*.py"))
    bench = sorted((ROOT / "bench_torch").rglob("*.py"))
    files = port + bench + [ROOT / "chip_smoke.py"]
    assert len(port) > 20 and len(bench) >= 4
    names = {str(f.relative_to(ROOT / "dynosam_tpu_torch")) for f in port}
    assert {"parallel/mesh.py", "parallel/multihost.py", "parallel/schur_dist.py", "parallel/distributed_ba.py",
            "parallel/batch_eval.py", "parallel/mp_worker.py", "utils/debug.py", "utils/histogram.py",
            "viz/visualizer.py", "eval/plotting.py", "scripts/run_experiments.py", "scripts/experiment_sweep.py",
            "scripts/sliding_vs_batch.py", "scripts/ab_accuracy.py", "scripts/run_cli_demo.py",
            "scripts/kitti_semantic_to_motion.py", "testing/trace.py"} <= names
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip()) for f in files
            for pattern in (_IMPORT, _TOP_LEVEL_HOST_LIB) for m in pattern.finditer(f.read_text())]
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
    backend_cfg = golden_config(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynoPipeline(cam, backend_cfg)
    ds = RenderedDataset.__new__(RenderedDataset)      # never read: the device is resolved first
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_and_log(ds, backend_cfg, "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_from_packets([], backend_cfg)


class _Replay:
    """A dataset of no frames with the simulator's camera ground truth,
    for both packages' `run_and_log` (`DynoPipeline.run` patched to
    replay packets)."""

    start = 0

    def __init__(self, cam, scenario, gt_cls):
        self.cam, self.sc, self.gt_cls = cam, scenario, gt_cls

    def camera_params(self):
        return self.cam

    def prefetched_frames(self):
        return iter(())

    def ground_truth(self, idx):
        X = self.sc.X_gt[idx]
        return self.gt_cls(frame_id=idx, timestamp=idx * 0.1, X_world=_mat(X.R, X.t), object_poses={},
                           object_motions={})


def _read_rows(path):
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(x) for x in r] for r in rows[1:]]


def test_world_pose_backend_logs_match_jax(tmp_path, monkeypatch):
    """Updater 1 (WorldPose) through `run_and_log` with sliding windows 5/2
    over 10 simulator frames, `DynoPipeline.run` replaying the packets
    through each package's own backend: the backend logs go under
    `rgbd_LL_world_backend` in both packages, and on one backend state
    (JAX's estimates handed to the port's backend) the port's camera and
    object-motion logs hold JAX's rows and values (motions H_k = L_k
    L_{k-1}^-1 from the accessor) to 1e-5; the port's own solve of the
    same packets is read back by `evaluate_all` under that prefix, its
    camera ATE within 3e-3 m of JAX's."""
    from dynosam_tpu import pipeline as jpipe
    from dynosam_tpu.core.camera import CameraParams as JCameraParams
    from dynosam_tpu.data.base import GroundTruthFrame as JGT
    from dynosam_tpu.eval.evaluator import evaluate_all as jevaluate_all
    from dynosam_tpu.testing.simulator import ScenarioConfig
    from dynosam_tpu.utils import config as jcfg
    from dynosam_tpu_torch.pipeline import PipelineResult

    from test_torch_schur import jax_packets, port_packets, scenario

    scfg = ScenarioConfig(n_frames=10)
    sc, packets, tp = scenario(scfg)[0], jax_packets(scfg), port_packets(scfg)
    kw = dict(backend_updater_enum=1, opt_window_size=5, opt_window_overlap=2, lm_max_iterations=8)

    def cfg(mod):
        return mod.DynoConfig(backend=mod.BackendConfig(**kw), pipeline=mod.PipelineConfig(use_backend=True),
                              capacity=mod.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd,
                                                          max_objects=scfg.no, max_frames=scfg.n_frames))

    jb = jpipe.run_from_packets(packets, cfg(jcfg))
    monkeypatch.setattr(jpipe.DynoPipeline, "run", lambda self, frames: jpipe.PipelineResult(
        packets=packets, backend=jb, frontend_state=None, fps=0.0))
    jpipe.run_and_log(_Replay(JCameraParams.create(100.0, 100.0, 32.0, 24.0, 64, 48), sc, JGT), cfg(jcfg),
                      str(tmp_path / "jax"))

    from dynosam_tpu_torch.data.base import GroundTruthFrame
    from dynosam_tpu_torch.pipeline import DynoPipeline as TPipe

    cam = convert.camera_from_numpy(dict(fx=100.0, fy=100.0, cx=32.0, cy=24.0, width=64, height=48))
    shared = run_from_packets(tp, cfg(tcfg), device="cpu")
    from types import SimpleNamespace

    shared.est = convert.est_store_from_numpy(
        SimpleNamespace(**jax.tree.map(np.asarray, dataclasses.asdict(jb.est))), device="cpu")
    own = run_from_packets(tp, cfg(tcfg), device="cpu")
    for name, backend in (("shared", shared), ("port", own)):
        monkeypatch.setattr(TPipe, "run", lambda self, frames, b=backend: PipelineResult(
            packets=tp, backend=b, frontend_state=None, fps=0.0))
        run_and_log(_Replay(cam, sc, GroundTruthFrame), cfg(tcfg), str(tmp_path / name), device="cpu")

    for log in ("camera_pose_log", "object_motion_log"):
        hj, rj = _read_rows(tmp_path / "jax" / f"rgbd_LL_world_backend_{log}.csv")
        ht, rt = _read_rows(tmp_path / "shared" / f"rgbd_LL_world_backend_{log}.csv")
        assert ht == hj and len(rt) == len(rj) > 0, log
        np.testing.assert_allclose(np.asarray(rt), np.asarray(rj), rtol=0, atol=1e-5)
    assert not list((tmp_path / "port").glob("rgbd_motion_world_backend*"))
    ev, jev = evaluate_all(str(tmp_path / "port")), jevaluate_all(str(tmp_path / "jax"))
    assert ev["rgbd_LL_world_backend"]["camera"]["n_frames"] == scfg.n_frames
    assert abs(ev["rgbd_LL_world_backend"]["camera"]["ate_trans_rmse"]
               - jev["rgbd_LL_world_backend"]["camera"]["ate_trans_rmse"]) <= 3e-3
