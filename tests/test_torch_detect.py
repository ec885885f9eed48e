"""Port parity for detection: CLAHE, the plain version of kernel K3 (the
Shi-Tomasi response), grid NMS and the occupancy / label helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dynosam_tpu.frontend import detect as jdet
from dynosam_tpu.frontend.mask_ops import label_counts as j_label_counts
from dynosam_tpu.ops.clahe import clahe as j_clahe
from dynosam_tpu.ops.pallas import response as jresp
from dynosam_tpu.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch.frontend import detect as tdet
from dynosam_tpu_torch.frontend.mask_ops import label_counts as t_label_counts
from dynosam_tpu_torch.kernels.response import shi_tomasi_response_plain
from dynosam_tpu_torch.ops.clahe import clahe as t_clahe

torch.set_num_threads(2)

T = lambda a, dt=np.float32: torch.as_tensor(np.array(np.asarray(a), dt))


@pytest.fixture(scope="module")
def scene_frame():
    return RenderedScene(RenderConfig(n_frames=1, h=192, w=256, n_objects=2)).frames()[0]


def test_clahe_matches_jax(scene_frame):
    """64-bin CLAHE (the tracker's detector input), bf16 rounding of the
    soft-CDF operands reproduced: within 1e-3 grey levels everywhere (the
    f32 sums run in another order)."""
    g = np.asarray(scene_frame.gray)
    want = np.asarray(j_clahe(jnp.asarray(g), n_bins=64))
    got = t_clahe(T(g), n_bins=64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("source", ["noise", "rendered"])
def test_k3_plain_matches_fast_whole_image(rng, scene_frame, source):
    """K3 plain == `shi_tomasi_response_fast` on the WHOLE image, borders
    included.  `_fast` forms its box sums from an f32 integral image whose
    cancellation error grows with the image; the plain version sums
    directly.  Tolerance: 1e-4 of max |response|."""
    if source == "noise":
        g = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    else:
        g = np.asarray(scene_frame.gray)
    want = np.asarray(jdet.shi_tomasi_response_fast(jnp.asarray(g)))
    got = shi_tomasi_response_plain(T(g)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4


def test_k3_plain_matches_pallas_interior(rng):
    """K3 plain == the Pallas response kernel (interpret) in the interior
    [4:-4] (the Pallas body edge-replicates its box sums, `_fast` and the
    port take zeros outside, so only the interior is shared): 1e-5 of the
    mean |response|."""
    g = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    out = pl.pallas_call(
        jresp._response_kernel,
        out_shape=jax.ShapeDtypeStruct(g.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(g))
    a = shi_tomasi_response_plain(T(g)).numpy()[4:-4, 4:-4]
    b = np.asarray(out)[4:-4, 4:-4]
    assert np.abs(a - b).max() / np.abs(b).mean() < 1e-5


def test_grid_nms_matches_jax(scene_frame, rng):
    """Same response and forbid mask -> the same detections, in the same
    order (first maximum per cell, lower index first among equal cells)."""
    g = jnp.asarray(np.asarray(scene_frame.gray))
    resp = np.asarray(jdet.shi_tomasi_response_fast(g))
    forbid = (np.asarray(scene_frame.mask) != 0) | (rng.uniform(size=resp.shape) < 0.2)
    for max_corners in (150, 400):      # fewer and more than the cell count
        want = jdet.detect_grid_nms(jnp.asarray(resp), jnp.asarray(forbid), max_corners=max_corners, cell_size=15)
        got = tdet.detect_grid_nms(T(resp), T(forbid, bool), max_corners=max_corners, cell_size=15)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        v = np.asarray(want.valid)
        np.testing.assert_array_equal(got.uv.numpy()[v], np.asarray(want.uv)[v])
        np.testing.assert_array_equal(got.score.numpy()[v], np.asarray(want.score)[v])


def test_occupancy_and_grid_helpers_match_jax(scene_frame, rng):
    h, w = 192, 256
    uv = rng.uniform([-5, -5], [w + 5, h + 5], (300, 2)).astype(np.float32)
    valid = rng.uniform(size=300) > 0.3
    for r in (0, 2, 8):
        a = np.asarray(jdet.occupancy_mask((h, w), jnp.asarray(uv), jnp.asarray(valid), r))
        b = tdet.occupancy_mask((h, w), T(uv), T(valid, bool), r).numpy()
        np.testing.assert_array_equal(a, b)
    a = np.asarray(jdet.occupancy_at_grid((h, w), jnp.asarray(uv), jnp.asarray(valid), 2, 4, 2))
    b = tdet.occupancy_at_grid((h, w), T(uv), T(valid, bool), 2, 4, 2).numpy()
    np.testing.assert_array_equal(a, b)
    mask = np.asarray(scene_frame.mask)
    np.testing.assert_array_equal(
        np.asarray(jdet.grid_subsample_i32(jnp.asarray(mask), 4, 2)),
        tdet.grid_subsample_i32(T(mask, np.int32), 4, 2).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jdet.border_mask((h, w), 4, 6)), tdet.border_mask((h, w), 4, 6).numpy()
    )
    lab = rng.integers(-3, 300, (h, w)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(j_label_counts(jnp.asarray(lab), 256)), t_label_counts(T(lab, np.int32), 256).numpy()
    )
