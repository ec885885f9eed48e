"""Port parity for `frontend/stereo.py` (the plane-sweep block matcher,
depth conversion, `dense_stereo`, SGBM) against the JAX package's.

On the textured pairs of `tests/test_stereo.py` (64x128, a Gaussian-
filtered texture shifted by a known disparity) the port's `block_match`
gives the same valid pixels and integer disparities as `block_match_jax`,
and sub-pixel disparities within 1e-4 px: both sum the same |differences|
in float32, in another order (the port's box sum is separable), which
moves a cost by ~1e-5 of its size.  The SGBM path runs the same OpenCV
call and equals JAX's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from dynosam_tpu.core.camera import CameraParams as JCameraParams
from dynosam_tpu.core.camera import StereoParams as JStereoParams
from dynosam_tpu.frontend import stereo as jst
from dynosam_tpu_torch.core.camera import CameraParams, StereoParams
from dynosam_tpu_torch.frontend import stereo as tst

torch.set_num_threads(2)


def _pair(seed, d, h=64, w=128):
    tex = gaussian_filter(np.random.default_rng(seed).uniform(0, 255, (h, w + 32)), 1.0).astype(np.float32)
    return tex[:, 16:16 + w].copy(), tex[:, 16 + d:16 + d + w].copy()


@pytest.mark.parametrize("seed,d,max_disparity", [(0, 8, 32), (1, 13, 24)])
def test_block_match_matches_jax(seed, d, max_disparity):
    left, right = _pair(seed, d)
    want = np.asarray(jst.block_match_jax(jnp.asarray(left), jnp.asarray(right), max_disparity=max_disparity))
    got = tst.block_match(torch.as_tensor(left), torch.as_tensor(right), max_disparity=max_disparity).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    v = want > 0
    np.testing.assert_array_equal(np.round(got[v] - 0.5 + 1e-6), np.round(want[v] - 0.5 + 1e-6))
    np.testing.assert_allclose(got, want, atol=1e-4)
    inner = got[8:-8, 40:-8]
    assert (np.abs(inner - d) < 1.0).mean() > 0.8


def test_dense_stereo_depth_matches_jax():
    left, right = _pair(2, 8)
    jres = jst.dense_stereo(jnp.asarray(left), jnp.asarray(right),
                            JStereoParams(JCameraParams.create(100.0, 100.0, 64.0, 32.0, 128, 64),
                                          jnp.asarray(0.5, jnp.float32)), max_disparity=32)
    tres = tst.dense_stereo(torch.as_tensor(left), torch.as_tensor(right),
                            StereoParams(CameraParams.create(100.0, 100.0, 64.0, 32.0, 128, 64), 0.5),
                            max_disparity=32)
    np.testing.assert_allclose(tres.depth.numpy(), np.asarray(jres.depth), rtol=1e-4)
    # the same disparities convert to the same depths, bit for bit
    disp = jres.disparity
    np.testing.assert_array_equal(
        tst.disparity_to_depth(torch.as_tensor(np.array(disp)), StereoParams(
            CameraParams.create(100.0, 100.0, 64.0, 32.0, 128, 64), 0.5)).numpy(),
        np.asarray(jst.disparity_to_depth(disp, JStereoParams(
            JCameraParams.create(100.0, 100.0, 64.0, 32.0, 128, 64), jnp.asarray(0.5, jnp.float32)))))
    depth = tres.depth.numpy()[8:-8, 40:-8]
    assert abs(np.median(depth[depth > 0]) - 100.0 * 0.5 / 8) / (100.0 * 0.5 / 8) < 0.1


def test_sgbm_matches_jax():
    pytest.importorskip("cv2")
    left, right = _pair(3, 8)
    cam_j = JCameraParams.create(100.0, 100.0, 64.0, 32.0, 128, 64)
    jres = jst.sgbm_cv2(left, right, JStereoParams(cam_j, jnp.asarray(0.5, jnp.float32)), max_disparity=32)
    tres = tst.sgbm_cv2(left, right, StereoParams(CameraParams.create(100.0, 100.0, 64.0, 32.0, 128, 64), 0.5),
                        max_disparity=32)
    np.testing.assert_array_equal(tres.disparity.numpy(), np.asarray(jres.disparity))
    np.testing.assert_array_equal(tres.depth.numpy(), np.asarray(jres.depth))
