"""Port parity for `core/distortion.py`, `core/camera.py:distortion_from_yaml`
and `frontend/rectify.py` against the JAX package, and the rectifier hook of
`data/base.py`.

Both packages evaluate the same float32 formulas; the point models and
the undistortion map are held to 1e-4 px (measured: equal, or one float32
ulp, 7.6e-6 px, apart).  The rectifier samples through K2's plain version here and
through XLA in JAX: gray and flow within 1e-3 (grey levels of ~1, px),
depth and mask on the same nearest pixels except where a map coordinate
sits within float32 noise of a half pixel (at most 0.1 % of pixels).  On a
synthetically distorted frame (the scheme of `tests/test_distortion.py`,
radtan [-0.15, 0.03, 0, 0], here 96x128) the rectified interior recovers
the undistorted frame and a constant rectified motion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.core import distortion as jd
from dynosam_tpu.core.camera import CameraParams as JCameraParams
from dynosam_tpu.core.camera import distortion_from_yaml as j_from_yaml
from dynosam_tpu.frontend.frontend import FrameImages as JFrameImages
from dynosam_tpu.frontend.rectify import make_rectifier as j_make_rectifier
from dynosam_tpu_torch.core import distortion as td
from dynosam_tpu_torch.core.camera import CameraParams, distortion_from_yaml
from dynosam_tpu_torch.data.base import DatasetProvider
from dynosam_tpu_torch.frontend.frontend import FrameImages
from dynosam_tpu_torch.frontend.rectify import make_rectifier

torch.set_num_threads(2)

H, W = 96, 128
JCAM = JCameraParams.create(64.0, 64.0, 64.0, 48.0, W, H)
CAM = CameraParams.create(64.0, 64.0, 64.0, 48.0, W, H)
MODELS = {"radtan": (-0.28, 0.07, 1e-4, -2e-4), "equidistant": (-0.01, 0.02, -0.005, 0.001)}


def _dists(model, coeffs=None):
    c = np.asarray(coeffs or MODELS[model], np.float32)
    return td.Distortion(tuple(float(x) for x in c), model), jd.Distortion(jnp.asarray(c), model)


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_point_models_match_jax(model):
    t, j = _dists(model)
    uv = np.random.default_rng(0).uniform([10, 8], [W - 10, H - 8], (300, 2)).astype(np.float32)
    dj = np.array(jax.jit(lambda x: jd.distort_points(x, JCAM, j))(jnp.asarray(uv)))
    dt = td.distort_points(torch.as_tensor(uv), CAM, t).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-4)
    for iters in (8, 12):
        uj = np.asarray(jax.jit(lambda x: jd.undistort_points(x, JCAM, j, iters=iters))(jnp.asarray(dj)))
        ut = td.undistort_points(torch.as_tensor(dj), CAM, t, iters=iters).numpy()
        np.testing.assert_allclose(ut, uj, atol=1e-4)
    np.testing.assert_allclose(ut, uv, atol=0.1)


def test_map_and_remap_match_jax():
    t, j = _dists("radtan", (-0.1, 0.01, 0.0, 0.0))
    mj = np.array(jax.jit(lambda: jd.undistort_rectify_map(JCAM, j))())
    mt = td.undistort_rectify_map(CAM, t, "cpu")
    assert mt.dtype == torch.float32 and mt.shape == (H, W, 2)
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-4)
    img = np.random.default_rng(1).uniform(0, 255, (H, W)).astype(np.float32)
    np.testing.assert_allclose(td.remap_bilinear(torch.as_tensor(img), torch.as_tensor(mj)).numpy(),
                               np.asarray(jax.jit(jd.remap_bilinear)(jnp.asarray(img), jnp.asarray(mj))), atol=1e-3)


def test_distortion_from_yaml_matches_jax(tmp_path):
    p = tmp_path / "cam.yaml"
    p.write_text("Camera.fx: 100.0\nCamera.distortion_model: plumb_bob\n"
                 "Camera.distortion_coefficients: [-0.2, 0.05, 0.001, -0.002]\n")
    t, j = distortion_from_yaml(str(p)), j_from_yaml(str(p))
    assert t.model == j.model == "radtan"
    np.testing.assert_array_equal(np.asarray(t.coeffs, np.float32), np.asarray(j.coeffs))
    p2 = tmp_path / "rect.yaml"
    p2.write_text("Camera.fx: 100.0\nCamera.distortion_coefficients: [0, 0, 0, 0]\n")
    assert distortion_from_yaml(str(p2)) is None and j_from_yaml(str(p2)) is None


@pytest.fixture(scope="module")
def distorted():
    """A structured frame, its distorted version and a constant rectified
    motion c encoded in distorted space (`tests/test_distortion.py:84-121`)."""
    t, j = _dists("radtan", (-0.15, 0.03, 0.0, 0.0))
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32), torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    gray = torch.sin(xx * 0.2) * torch.cos(yy * 0.25)
    depth = torch.where(xx < W / 2, 5.0, 9.0)
    mask = ((xx > W * 0.3) & (xx < W * 0.5) & (yy > H * 0.3) & (yy < H * 0.6)).to(torch.int32) * 3
    grid = torch.stack([xx, yy], -1).reshape(-1, 2)
    src = td.undistort_points(grid, CAM, t)
    from dynosam_tpu_torch.ops.klt import bilinear_sample, nearest_at

    c = torch.tensor([1.5, -1.0])
    frame_d = FrameImages(
        gray=bilinear_sample(gray, src).reshape(H, W),
        depth=nearest_at(depth, src).reshape(H, W),
        flow=(td.distort_points(src + c, CAM, t) - grid).reshape(H, W, 2),
        mask=nearest_at(mask, src).reshape(H, W),
    )
    return dict(t=t, j=j, gray=gray, depth=depth, mask=mask, c=c, frame_d=frame_d)


def test_rectifier_matches_jax(distorted):
    f = distorted["frame_d"]
    got = make_rectifier(CAM, distorted["t"], device="cpu")(f)
    want = jax.jit(j_make_rectifier(JCAM, distorted["j"]))(JFrameImages(*(jnp.asarray(x.numpy()) for x in f)))
    assert got.mask.dtype == torch.int32 and got.flow.shape == (H, W, 2)
    np.testing.assert_allclose(got.gray.numpy(), np.asarray(want.gray), atol=1e-3)
    np.testing.assert_allclose(got.flow.numpy(), np.asarray(want.flow), atol=1e-3)
    assert (got.depth.numpy() != np.asarray(want.depth)).mean() <= 1e-3
    assert (got.mask.numpy() != np.asarray(want.mask)).mean() <= 1e-3


def test_rectifier_recovers_the_frame(distorted):
    out = make_rectifier(CAM, distorted["t"], device="cpu")(distorted["frame_d"])
    sl = (slice(12, H - 12), slice(16, W - 16))
    np.testing.assert_allclose(out.gray[sl].numpy(), distorted["gray"][sl].numpy(), atol=0.05)
    assert (out.mask[sl] == distorted["mask"][sl]).float().mean() > 0.99
    assert (out.depth[sl] == distorted["depth"][sl]).float().mean() > 0.99
    np.testing.assert_allclose(out.flow[sl].numpy(), np.broadcast_to(distorted["c"].numpy(), out.flow[sl].shape),
                               atol=0.05)
    # outside the distorted image: invalid depth, background, no flow
    out_side = ~torch.isfinite(out.gray) | (out.depth == 0)
    assert bool((out.mask[out_side] == 0).all())


class _Frames(DatasetProvider):
    def __init__(self, frames, distortion):
        super().__init__("<frames>", device="cpu")
        self._frames, self.distortion = frames, distortion

    def __len__(self):
        return len(self._frames)

    def camera_params(self):
        return CAM

    def frame(self, idx):
        return self._frames[idx]


def test_dataset_frames_are_rectified(distorted):
    f = distorted["frame_d"]
    ds = _Frames([f, f], distorted["t"])
    want = make_rectifier(CAM, distorted["t"], device="cpu")(f)
    for got in (list(ds.frames()) + list(ds.prefetched_frames())):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    ds.distortion = None
    ds._rectifier = None
    assert all(torch.equal(a, b) for a, b in zip(next(ds.frames()), f))
