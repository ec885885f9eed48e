"""The port's dataset layer and CLI (`dynosam_tpu_torch/testing/render.py:
write_reference_layout`, `data/kitti.py`, `data/factory.py`,
`__main__.py`) against the JAX package's, and the dataset-dir -> CLI ->
report loop of `tests/test_cli_e2e.py` on the port.

* The layout the port writes reads back through the port's `KittiDataset`
  exactly as through the JAX package's (frames, camera and ground truth
  equal), and within the quantisation of the PNGs (8-bit gray, 16-bit
  disparity) of the rendered frames.
* `python -m dynosam_tpu_torch --device cpu ...` on a 16-frame 192x256
  layout writes the CSV logs and the evaluation, exits 0, and its
  results pass the bands of `tests/test_cli_e2e.py` (camera ATE < 0.15 m
  for both modules, an object AME < 0.35 m).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynosam_tpu.__main__ import main as jmain
from dynosam_tpu.data.kitti import KittiDataset as JKittiDataset
from dynosam_tpu_torch.__main__ import main as tmain
from dynosam_tpu_torch.data.factory import create_dataset
from dynosam_tpu_torch.data.kitti import KittiDataset
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene, write_reference_layout

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _scene(n_frames, n_objects):
    return RenderedScene(RenderConfig(n_frames=n_frames, h=192, w=256, fx=200.0, n_objects=n_objects,
                                      yaw_only_objects=True), device="cpu")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    sc = _scene(4, 2)
    root = str(tmp_path_factory.mktemp("layout") / "0000")
    write_reference_layout(sc, root)
    return sc, root


def test_kitti_dataset_matches_jax_loader(layout):
    sc, root = layout
    t, j = KittiDataset(root), JKittiDataset(root)
    assert len(t) == len(j) == 4
    assert t.camera_params() == tuple(j.camera_params())
    for k in range(4):
        a, b = t.frame(k), j.frame(k)
        for f in ("gray", "depth", "flow", "mask"):
            x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), (k, f)
        ga, gb = t.ground_truth(k), j.ground_truth(k)
        assert np.array_equal(ga.X_world, gb.X_world) and ga.timestamp == gb.timestamp
        for key in ("object_poses", "object_motions"):
            da, db = getattr(ga, key), getattr(gb, key)
            assert set(da) == set(db) == (set(sc.object_labels) if key == "object_poses" or k else set())
            assert all(np.array_equal(da[o], db[o]) for o in da)
    assert [f.gray.shape for f in t.frames()] == [(192, 256)] * 4


def test_layout_round_trip(layout):
    """The frames and ground truth read back within the PNG quantisation."""
    sc, root = layout
    ds = KittiDataset(root)
    src, got = sc.frames()[1], ds.frame(1)
    assert (got.gray - src.gray).abs().max() <= 1.0
    assert (got.depth - src.depth).abs().max() < 2e-3
    assert torch.equal(got.flow, src.flow) and torch.equal(got.mask, src.mask)
    X = np.eye(4)
    X[:3, :3], X[:3, 3] = sc.X_gt[2].R.numpy(), sc.X_gt[2].t.numpy()
    np.testing.assert_allclose(ds.ground_truth(2).X_world, X, atol=1e-6)
    L = sc.object_pose_at(2, 0)
    np.testing.assert_allclose(ds.ground_truth(2).object_poses[sc.object_labels[0]][:3, 3], L.t.numpy(), atol=1e-5)


def test_cli_dataset_to_report(tmp_path):
    """`python -m dynosam_tpu_torch --device cpu --dataset_path <dir>
    --output_path <out>`: loader -> frontend -> backend -> CSV logs ->
    evaluate_all, exit 0, results within the bands."""
    root, out = str(tmp_path / "0000"), str(tmp_path / "out")
    write_reference_layout(_scene(16, 2), root)
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "dynosam_tpu_torch", "--device", "cpu", "--dataset_path", root,
           "--output_path", out,
           "--set", "capacity.max_static_tracks=512", "--set", "capacity.max_dynamic_tracks=512",
           "--set", "capacity.max_objects=8", "--set", "capacity.max_frames=16",
           "--set", "frontend.tracker.max_features_per_frame=300"]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-4000:]
    assert run.stdout.strip().splitlines()[-1].startswith("done: 16 frames at")
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    assert set(results) == {"frontend", "rgbd_motion_world_backend"}
    fe, be = results["frontend"], results["rgbd_motion_world_backend"]
    assert fe["camera"]["ate_trans_rmse"] < 0.15, fe["camera"]
    assert be["camera"]["ate_trans_rmse"] < 0.15, be["camera"]
    assert be["camera"]["n_frames"] == 16
    assert fe.get("objects"), "no objects evaluated"
    assert min(v["ame_trans_rmse"] for v in fe["objects"].values()) < 0.35, fe["objects"]
    for name in ("frontend_camera_pose_log.csv", "frontend_object_motion_log.csv",
                 "rgbd_motion_world_backend_camera_pose_log.csv", "statistics_summary.csv",
                 "statistics_samples.csv"):
        assert os.path.exists(os.path.join(out, name)), name


@pytest.mark.parametrize("argv", [[], ["--no_backend", "--set", "backend.opt_window_size=12",
                                       "--set", "frontend.tracker.use_clahe=false"]])
def test_show_dyno_args_prints_the_jax_json(argv):
    outs = []
    for main in (jmain, tmain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--dataset_path", "unused", "--show_dyno_args", *argv]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    cfg = json.loads(outs[1])
    assert cfg["pipeline"]["use_backend"] is (not argv)


def test_cli_raises_without_a_card(monkeypatch, tmp_path):
    """Without `--device` the CLI asks for CUDA and raises when no card is
    present, before it reads the dataset."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain(["--dataset_path", str(tmp_path / "missing"), "--output_path", str(tmp_path / "out")])


@pytest.mark.parametrize("provider", [1, 2, 3, 4])
def test_other_loaders_raise(provider, tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md item 15"):
        create_dataset(provider, str(tmp_path))
