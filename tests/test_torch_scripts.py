"""The port's evaluation tools (`dynosam_tpu_torch/scripts/`) against the
JAX package's scripts (`scripts/*.py`, imported by path: their `main`
runs only under `__main__`, so nothing runs or writes on import).

* `parse_value` on a list of strings, `SWEEP` and `BASE`: equal to the
  JAX scripts' own.
* sliding vs batch: the JAX simulator's 16-frame packets, converted,
  through both packages' `RGBDBackend` (sliding 10/4, then full batch)
  and the JAX script's error computation: the per-frame camera
  translation errors within 3e-3 m (sliding) and 5e-4 m (full batch), the
  float32 floor `tests/f32_spread.py` item 6 measures for these backend
  runs (the same floors as `tests/test_torch_backend_online.py`);
  measured 1.2e-3 and 3.9e-4 m.
* one sweep row (`wm_fullbatch`) on one written 8-frame 192x256 layout,
  read by JAX's `run_and_log` + `evaluate_all` as the JAX sweep's loop
  does and by the port's `sweep_row`: `fe_ate_trans` within 1e-3 m and
  `be_ate_trans` within 1e-3 m (measured 1.3e-5 and 1.1e-4 m; the RANSAC
  draws differ between the packages, see ROADMAP's Randomness rule, and
  the port's bands `tests/test_torch_pipeline.py:354-355` allow 3e-3 m);
  the row's `results.json` holds its numbers, and `run_experiments`
  with `--no_backend` on the same layout gives the row's frontend ATE
  exactly (one seeded CPU pipeline).
* `kitti_semantic_to_motion`: the masks the port writes equal, pixel for
  pixel, the JAX script's selection (`scripts/kitti_semantic_to_motion.py:36-45`)
  applied here to the JAX loader's frames, at thresholds that keep every,
  some and no object, and read back unchanged through the port's loader.
* every tool raises without a card unless given `--device cpu`.
"""

import importlib.util
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynosam_tpu.core import lie as jlie
from dynosam_tpu.data.kitti import KittiDataset as JKittiDataset
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.data.kitti import KittiDataset
from dynosam_tpu_torch.scripts import (
    ab_accuracy,
    experiment_sweep,
    kitti_semantic_to_motion,
    run_cli_demo,
    run_experiments,
    sliding_vs_batch,
)
from dynosam_tpu_torch.utils import config as tcfg

from test_torch_schur import jax_packets, port_packets, scenario

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
LAYOUT_FRAMES = 8


def jax_script(name: str):
    """The JAX package's `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parse_value_sweep_and_base_match_jax():
    jrun, jsweep = jax_script("run_experiments"), jax_script("experiment_sweep")
    for v in ("true", "False", "TRUE", "3", "-2", "007", "1.5", "-1e-3", "2E5", "inf", "nan", "0x10", "abc",
              "", "1_000", " 4 "):
        a, b = run_experiments.parse_value(v), jrun.parse_value(v)
        assert type(a) is type(b) and repr(a) == repr(b), (v, a, b)
    assert experiment_sweep.SWEEP == jsweep.SWEEP
    assert experiment_sweep.BASE == jsweep.BASE
    assert run_experiments.parse_overrides(["backend.opt_window_size=20", "backend.use_full_batch_opt=true"]) == {
        "backend.opt_window_size": 20, "backend.use_full_batch_opt": True}


def test_sliding_vs_batch_curves_match_jax():
    jsvb = jax_script("sliding_vs_batch")
    scfg = ScenarioConfig(n_frames=16)
    sc = scenario(scfg)[0]
    packets = jax_packets(scfg)
    se3_local = jax.jit(jlie.se3_local)
    jcap = jcfg.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd, max_objects=scfg.no,
                               max_frames=scfg.n_frames)
    jcurves = {}
    for name, cfg in (("sliding-window", jcfg.BackendConfig(use_full_batch_opt=False, opt_window_size=10,
                                                            opt_window_overlap=4)),
                      ("full-batch", jcfg.BackendConfig(use_full_batch_opt=True))):
        be = jsvb.run_backend(packets, cfg, jcap)
        X, xv = be.camera_poses()
        xv = np.asarray(xv)
        # the JAX script's error computation (`scripts/sliding_vs_batch.py:90-104`)
        errs = []
        for k in range(len(packets)):
            if not xv[k]:
                errs.append(np.nan)
                continue
            e = np.asarray(se3_local(sc.X_gt[k], jax.tree.map(lambda a: a[k], X)))
            errs.append(float(np.linalg.norm(e[3:])))
        jcurves[name] = np.asarray(errs)

    tpackets = port_packets(scfg)
    tcap = tcfg.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd, max_objects=scfg.no,
                               max_frames=scfg.n_frames)
    gt = SE3(torch.as_tensor(np.array(sc.X_gt.R)), torch.as_tensor(np.array(sc.X_gt.t)))
    runs = sliding_vs_batch.compare(tpackets, tcap, gt, 10, 4, device="cpu")
    for name, tol in (("sliding-window", 3e-3), ("full-batch", 5e-4)):
        t, j = runs[name]["curve"], jcurves[name]
        assert np.array_equal(np.isnan(t), np.isnan(j)) and not np.isnan(t).all(), name
        diff = float(np.nanmax(np.abs(t - j)))
        print(f"{name}: max |curve difference| {diff:.3g} m, JAX mean {np.nanmean(j):.4g} m")
        assert diff <= tol, (name, diff)
    lines = sliding_vs_batch.summary_lines(runs)
    assert [ln.split(":")[0] for ln in lines] == ["sliding-window", "full-batch"] * 2
    assert all("ATE trans mean" in ln for ln in lines[2:])


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """An 8-frame sweep layout written by the port's writer."""
    root = str(tmp_path_factory.mktemp("sweep") / "0000")
    experiment_sweep.write_layout(root, LAYOUT_FRAMES, 2, "cpu")
    return root


def test_sweep_row_matches_jax(layout, tmp_path):
    """`wm_fullbatch`: JAX's loop body of `scripts/experiment_sweep.py:86-91`
    against the port's `sweep_row` on the same layout, then
    `run_experiments` under the same overrides."""
    from dynosam_tpu.data.factory import create_dataset as jcreate
    from dynosam_tpu.eval.evaluator import evaluate_all as jevaluate
    from dynosam_tpu.pipeline import run_and_log as jrun_and_log

    jsweep = jax_script("experiment_sweep")
    overrides = dict(jsweep.SWEEP)["wm_fullbatch"]
    ov = dict(jsweep.BASE)
    ov["capacity.max_frames"] = LAYOUT_FRAMES
    ov.update(overrides)
    jrun_and_log(jcreate(0, layout), jcfg.load_config(None, ov), str(tmp_path / "jax"))
    jres = jevaluate(str(tmp_path / "jax"))
    row = experiment_sweep.sweep_row(layout, overrides, LAYOUT_FRAMES, str(tmp_path / "port"), device="cpu")
    jfe = jres["frontend"]["camera"]["ate_trans_rmse"]
    jbe = jres["rgbd_motion_world_backend"]["camera"]["ate_trans_rmse"]
    print(f"fe_ate_trans port {row['fe_ate_trans']:.6g} JAX {jfe:.6g}; be_ate_trans port {row['be_ate_trans']:.6g} "
          f"JAX {jbe:.6g}")
    assert abs(row["fe_ate_trans"] - jfe) <= 1e-3
    assert abs(row["be_ate_trans"] - jbe) <= 1e-3
    assert set(row) == {"wall_s", "config", "be_ate_trans", "be_ate_rot_deg", "be_ame_trans", "be_ame_rot_deg",
                        "fe_ate_trans"}

    assert json.loads((tmp_path / "port" / "results.json").read_text())["frontend"]["camera"]["ate_trans_rmse"] \
        == row["fe_ate_trans"]

    # the runner's CLI on the same layout, frontend only: the row's
    # frontend, to the bit (one seeded CPU pipeline; the backend feeds
    # nothing back to the frontend)
    sets = [f"{k}={v}" for k, v in {**jsweep.BASE, "capacity.max_frames": LAYOUT_FRAMES}.items()]
    argv = ["--dataset_path", layout, "--output_path", str(tmp_path / "runs"), "--name", "frontend",
            "--no_backend", "--device", "cpu"] + [a for s in sets for a in ("--set", s)]
    assert run_experiments.main(argv) == 0
    res = json.loads((tmp_path / "runs" / "frontend" / "results.json").read_text())
    assert res["frontend"]["camera"]["ate_trans_rmse"] == row["fe_ate_trans"]
    assert not [k for k in res if k.endswith("backend")]
    assert (tmp_path / "runs" / "frontend" / "result_tables.tex").exists()


def test_semantic_to_motion_matches_jax_logic(layout, tmp_path):
    root = str(tmp_path / "0000")
    shutil.copytree(layout, root)
    os.rename(os.path.join(root, "motion"), os.path.join(root, "semantic"))
    jds = JKittiDataset(root, prefer_motion_mask=False)
    speeds = sorted({float(np.linalg.norm(H[:3, 3])) for k in range(len(jds))
                     for H in jds.ground_truth(k).object_motions.values()})
    thresholds = (0.05, float(np.median(speeds)), speeds[-1] + 1.0)
    kept = []
    for thr in thresholds:
        out_dir = kitti_semantic_to_motion.write_motion_masks(root, thr, device="cpu")
        back = KittiDataset(root)
        assert back.mask_dir == out_dir
        labels = set()
        for k in range(len(jds)):
            # the JAX script's selection (`scripts/kitti_semantic_to_motion.py:36-45`)
            gt = jds.ground_truth(k)
            moving = {obj for obj, H in gt.object_motions.items() if np.linalg.norm(H[:3, 3]) >= thr}
            mask = np.asarray(jds.frame(k).mask)
            want = np.where(np.isin(mask, list(moving)), mask, 0).astype(np.uint16)
            got = back.frame(k).mask.numpy()
            np.testing.assert_array_equal(got, want)
            labels |= set(np.unique(want[want > 0]).tolist())
        kept.append(len(labels))
    assert kept[0] == 2 and kept[-1] == 0 and 0 < kept[1] <= 2, kept


TOOL_ARGS = {
    "run_experiments": (run_experiments, ["--dataset_path", "unused", "--output_path", "unused"]),
    "experiment_sweep": (experiment_sweep, ["--out", "unused"]),
    "sliding_vs_batch": (sliding_vs_batch, ["--out", "unused.pdf"]),
    "ab_accuracy": (ab_accuracy, ["n_frames=2"]),
    "run_cli_demo": (run_cli_demo, ["--out", "unused"]),
    "kitti_semantic_to_motion": (kitti_semantic_to_motion, ["--dataset_path", "unused"]),
}


@pytest.mark.parametrize("tool", sorted(TOOL_ARGS))
def test_tool_raises_without_a_card(tool, monkeypatch, tmp_path):
    """Each tool's `main`, without `--device`, on a machine without a card:
    raises before it reads or writes anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = TOOL_ARGS[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []
