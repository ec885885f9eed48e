"""Port parity for the dataset loaders (`data/{kitti,vkitti,cluster,omd,
aria,base,factory}.py`) against the JAX package's, on the on-disk fixtures
of `tests/test_data.py` (`make_fake_{kitti,omd,cluster,vkitti}` and the
Aria layout of its `test_aria_loader`), and the CLI on each provider type.

Loaders decode with numpy on the host in both packages, so frames, camera
and ground truth are held bit for bit.  The Virtual KITTI fixture gains
depth, flow and instance PNGs here so that its frames load (the JAX
fixture writes only RGB and text ground truth).  The Cluster loader's
device-side stereo (`stereo_backend="device"`, the JAX package's "jax")
runs the port's block matcher: valid pixels equal and depth within 1e-4
relative (`tests/test_torch_stereo.py` holds the matcher).  The CLI runs
`python -m dynosam_tpu_torch --device cpu --data_provider_type N` for
N = 0-4 in process on small capacities; the JAX factory passes the frame
range by position, which breaks type 1 there (ROADMAP.md, F3), so the
port's factory is held against the JAX loaders built by keyword.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_data import make_fake_cluster, make_fake_kitti, make_fake_omd, make_fake_vkitti  # noqa: E402

from dynosam_tpu.data import aria as jaria  # noqa: E402
from dynosam_tpu.data import base as jbase  # noqa: E402
from dynosam_tpu.data import cluster as jcluster  # noqa: E402
from dynosam_tpu.data import kitti as jkitti  # noqa: E402
from dynosam_tpu.data import omd as jomd  # noqa: E402
from dynosam_tpu.data import vkitti as jvkitti  # noqa: E402
from dynosam_tpu_torch.__main__ import main as tmain  # noqa: E402
from dynosam_tpu_torch.core.camera import CameraParams  # noqa: E402
from dynosam_tpu_torch.data import base as tbase  # noqa: E402
from dynosam_tpu_torch.data import vkitti as tvkitti  # noqa: E402
from dynosam_tpu_torch.data.factory import create_dataset  # noqa: E402

torch.set_num_threads(2)


def make_fake_aria(root, n=3, h=36, w=64):
    """The Aria layout of `tests/test_data.py:test_aria_loader`."""
    for d in ["rgb_sync", "depth_sync", "optical_flow", "instance_masks"]:
        os.makedirs(f"{root}/{d}", exist_ok=True)
    rng = np.random.default_rng(4)
    for k in range(n):
        stem = 1_000_000_000 + 100_000_000 * k
        cv2.imwrite(f"{root}/rgb_sync/{k:06d}.png", rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        cv2.imwrite(f"{root}/depth_sync/{k:06d}.png", np.full((h, w), 2500, np.uint16))
        flow = np.zeros((h, w, 2), np.float32)
        with open(f"{root}/optical_flow/{stem}.flo", "wb") as f:
            np.asarray([202021.25], np.float32).tofile(f)
            np.asarray([w, h], np.int32).tofile(f)
            flow.tofile(f)
        cv2.imwrite(f"{root}/instance_masks/{k:06d}.png", np.zeros((h, w), np.uint16))
    return root


def add_vkitti_images(root, n=3, h=48, w=64):
    """Depth (cm), forward flow (16UC3) and instance PNGs for
    `make_fake_vkitti`'s layout, so its frames load."""
    sub = "Scene01/clone/frames"
    rng = np.random.default_rng(7)
    dirs = {k: f"{root}/vkitti_2.0.3_{k}/{sub}/{v}/Camera_0" for k, v in
            (("depth", "depth"), ("forwardFlow", "forwardFlow"), ("instanceSegmentation", "instanceSegmentation"))}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for k in range(n):
        cv2.imwrite(f"{dirs['depth']}/depth_{k:05d}.png", rng.integers(300, 3000, (h, w)).astype(np.uint16))
        bgr = rng.integers(0, 65535, (h, w, 3)).astype(np.uint16)
        bgr[::5, :, 0] = 0                               # invalid flow rows
        cv2.imwrite(f"{dirs['forwardFlow']}/flow_{k:05d}.png", bgr)
        inst = np.zeros((h, w), np.uint8)
        inst[12:28, 10:30] = 1
        cv2.imwrite(f"{dirs['instanceSegmentation']}/instancegt_{k:05d}.png", inst)
    return root


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    d = tmp_path_factory.mktemp("layouts")
    return {
        0: make_fake_kitti(str(d / "kitti")),
        1: add_vkitti_images(make_fake_vkitti(str(d / "vkitti"))),
        2: make_fake_cluster(str(d / "cluster")),
        3: make_fake_omd(str(d / "omd")),
        4: make_fake_aria(str(d / "aria")),
    }


JAX_LOADERS = {0: jkitti.KittiDataset, 1: jvkitti.VirtualKittiDataset, 2: jcluster.ClusterSlamDataset,
               3: jomd.OMDDataset, 4: jaria.ProjectAriaDataset}


def _assert_same(t, j, n_gt=True):
    assert len(t) == len(j)
    assert t.camera_params() == tuple(j.camera_params())     # JAX's fields are float32
    for k in range(len(j)):
        a, b = t.frame(k), j.frame(k)
        for f in ("gray", "depth", "flow", "mask"):
            x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), (k, f)
        ga, gb = t.ground_truth(k), j.ground_truth(k)
        assert (ga is None) == (gb is None)
        if ga is not None:
            assert np.array_equal(ga.X_world, gb.X_world) and ga.timestamp == gb.timestamp
            for key in ("object_poses", "object_motions"):
                da, db = getattr(ga, key), getattr(gb, key)
                assert set(da) == set(db) and all(np.array_equal(da[o], db[o]) for o in da)


@pytest.mark.parametrize("provider", [0, 1, 2, 3, 4])
def test_loader_matches_jax(layouts, provider):
    """The factory's loader gives JAX's frames, camera and ground truth."""
    root = layouts[provider]
    t = create_dataset(provider, root, device="cpu")
    j = JAX_LOADERS[provider](root)
    _assert_same(t, j)
    assert len(list(t.prefetched_frames())) == len(t)
    sub = create_dataset(provider, root, starting_frame=1, ending_frame=2)
    assert [f.gray.shape for f in sub.frames()] == [t.frame(1).gray.shape]


def test_loader_extras_match_jax(layouts):
    """Loader-specific decodes: VKITTI flow and object boxes, Aria
    timestamps, the Cluster baseline and relabelling."""
    bgr = np.random.default_rng(0).integers(0, 65535, (10, 20, 3)).astype(np.uint16)
    bgr[3, :, 0] = 0
    np.testing.assert_array_equal(tvkitti.decode_vkitti_flow(bgr), jvkitti.decode_vkitti_flow(bgr))
    t, j = create_dataset(1, layouts[1]), jvkitti.VirtualKittiDataset(layouts[1])
    assert t.gt_bboxes == j.gt_bboxes
    t, j = create_dataset(4, layouts[4]), jaria.ProjectAriaDataset(layouts[4])
    assert [t.timestamp(k) for k in range(3)] == [j.timestamp(k) for k in range(3)]
    t, j = create_dataset(2, layouts[2]), jcluster.ClusterSlamDataset(layouts[2])
    assert t.baseline == j.baseline and int(t.frame(0).mask.max()) == 1


def test_cluster_device_stereo_matches_jax(layouts):
    t = create_dataset(2, layouts[2], stereo_backend="device", device="cpu")
    j = jcluster.ClusterSlamDataset(layouts[2], stereo_backend="jax")
    a, b = t.frame(0).depth.numpy(), np.asarray(j.frame(0).depth)
    np.testing.assert_array_equal(a > 0, b > 0)
    np.testing.assert_allclose(a, b, rtol=1e-4)
    good = a[a > 0]
    assert good.size > 500 and abs(np.median(good) - 3.0) < 0.5
    with pytest.raises(ValueError, match="device"):
        create_dataset(2, layouts[2], stereo_backend="jax")


def test_online_provider_matches_jax():
    cam = CameraParams.create(50.0, 50.0, 16.0, 12.0, 32, 24)
    rng = np.random.default_rng(0)
    t, j = tbase.OnlineDataProvider(cam), jbase.OnlineDataProvider(cam)
    gray, depth = rng.uniform(0, 255, (24, 32)), rng.uniform(1, 5, (24, 32))
    mask = rng.integers(0, 3, (24, 32))
    for p in (t, j):
        p.push(gray, depth, mask=mask)
        p.push(gray, depth, flow=np.ones((24, 32, 2)))
        p.close()
    assert len(t) == len(j) == 2
    for a, b in zip(t.frames(), j.frames()):
        for f in ("gray", "depth", "flow", "mask"):
            x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(RuntimeError):
        t.push(gray, depth)


@pytest.mark.parametrize("provider", [0, 1, 2, 3, 4])
def test_cli_runs_each_provider_type(layouts, provider, tmp_path):
    """`python -m dynosam_tpu_torch --device cpu --data_provider_type N`
    loads the fixture, runs the pipeline with its backend, writes the logs
    and evaluates them."""
    out = str(tmp_path / "out")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmain(["--device", "cpu", "--dataset_path", layouts[provider], "--data_provider_type", str(provider),
                    "--output_path", out, "--set", "capacity.max_static_tracks=256",
                    "--set", "capacity.max_dynamic_tracks=256", "--set", "capacity.max_objects=4",
                    "--set", "capacity.max_frames=8", "--set", "frontend.tracker.max_features_per_frame=100"])
    assert rc == 0
    n = len(create_dataset(provider, layouts[provider]))
    assert buf.getvalue().strip().splitlines()[-1].startswith(f"done: {n} frames at")
    assert os.path.exists(os.path.join(out, "frontend_camera_pose_log.csv"))
    with open(os.path.join(out, "results.json")) as f:
        json.load(f)


def test_factory_rejects_unknown_types(tmp_path):
    with pytest.raises(ValueError):
        create_dataset(9, str(tmp_path))
