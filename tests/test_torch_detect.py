"""Port parity for detection: CLAHE, the plain version of kernel K3 (the
Shi-Tomasi response), the FAST and Harris responses, grid NMS and the
occupancy / label helpers."""

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

# The JAX references, each under one `jax.jit` as the JAX frontend runs them
# (called eagerly, every primitive compiles on its own)
_clahe = jax.jit(j_clahe, static_argnames=("n_bins",))
_st_fast = jax.jit(jdet.shi_tomasi_response_fast)
_grid_nms = jax.jit(jdet.detect_grid_nms, static_argnames=("max_corners", "cell_size"))
_occupancy_mask = jax.jit(jdet.occupancy_mask, static_argnums=(0, 3))
_occupancy_at_grid = jax.jit(jdet.occupancy_at_grid, static_argnums=(0, 3, 4, 5))
_grid_subsample_i32 = jax.jit(jdet.grid_subsample_i32, static_argnums=(1, 2))
_border_mask = jax.jit(jdet.border_mask, static_argnums=(0, 1, 2))
_label_counts = jax.jit(j_label_counts, static_argnums=(1,))
_fast_response = jax.jit(jdet.fast_response, static_argnums=(1,))
_fast_response_pair = jax.jit(jdet.fast_response_pair, static_argnums=(1, 2))
_harris_response = jax.jit(jdet.harris_response)


@pytest.fixture(scope="module")
def scene_frame():
    return RenderedScene(RenderConfig(n_frames=1, h=192, w=256, n_objects=2)).frames()[0]


def test_clahe_matches_jax(scene_frame):
    """64-bin CLAHE (the tracker's detector input), bf16 rounding of the
    soft-CDF operands reproduced: within 1e-3 grey levels everywhere (the
    f32 sums run in another order)."""
    g = np.asarray(scene_frame.gray)
    want = np.asarray(_clahe(jnp.asarray(g), n_bins=64))
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
    want = np.asarray(_st_fast(jnp.asarray(g)))
    got = shi_tomasi_response_plain(T(g)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4


@pytest.mark.parametrize("shape", [(37, 53), (5, 1290), (400, 7), (1, 1)])
def test_k3_plain_matches_fast_on_odd_and_tiny_shapes(shape):
    """K3 plain == `shi_tomasi_response_fast` on shapes that are no
    multiple of the kernel's 28x32 block tile, down to one pixel, borders
    included (uniform noise from numpy): 1e-4 of max |response|, as on the
    whole images above (a 1x1 image has response 0 in both)."""
    g = np.random.default_rng(sum(shape)).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(_st_fast(jnp.asarray(g)))
    got = shi_tomasi_response_plain(T(g)).numpy()
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


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
    resp = np.asarray(_st_fast(g))
    forbid = (np.asarray(scene_frame.mask) != 0) | (rng.uniform(size=resp.shape) < 0.2)
    for max_corners in (150, 400):      # fewer and more than the cell count
        want = _grid_nms(jnp.asarray(resp), jnp.asarray(forbid), max_corners=max_corners, cell_size=15)
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
        a = np.asarray(_occupancy_mask((h, w), jnp.asarray(uv), jnp.asarray(valid), r))
        b = tdet.occupancy_mask((h, w), T(uv), T(valid, bool), r).numpy()
        np.testing.assert_array_equal(a, b)
    a = np.asarray(_occupancy_at_grid((h, w), jnp.asarray(uv), jnp.asarray(valid), 2, 4, 2))
    b = tdet.occupancy_at_grid((h, w), T(uv), T(valid, bool), 2, 4, 2).numpy()
    np.testing.assert_array_equal(a, b)
    mask = np.asarray(scene_frame.mask)
    np.testing.assert_array_equal(
        np.asarray(_grid_subsample_i32(jnp.asarray(mask), 4, 2)),
        tdet.grid_subsample_i32(T(mask, np.int32), 4, 2).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(_border_mask((h, w), 4, 6)), tdet.border_mask((h, w), 4, 6).numpy()
    )
    lab = rng.integers(-3, 300, (h, w)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(_label_counts(jnp.asarray(lab), 256)), t_label_counts(T(lab, np.int32), 256).numpy()
    )


@pytest.mark.parametrize("detector", ["fast", "fast_pair", "harris"])
@pytest.mark.parametrize("source", ["noise", "rendered"])
def test_fast_and_harris_responses_match_jax(rng, scene_frame, detector, source):
    """FAST-9/16 (one threshold, and the ORB pair 20/7 from one ring build)
    and Harris on the same image, borders included.  The FAST criterion
    and ring differences are exact, so its maps agree to float32 sum order
    (1e-4 of max |response|); Harris is two convolution layers deep, 1e-5
    of max |response|."""
    if source == "noise":
        g = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    else:
        g = np.asarray(scene_frame.gray)
    if detector == "fast":
        pairs = [(_fast_response(jnp.asarray(g), 20.0), tdet.fast_response(T(g), 20.0))]
    elif detector == "fast_pair":
        pairs = list(zip(_fast_response_pair(jnp.asarray(g), 20.0, 7.0),
                         tdet.fast_response_pair(T(g), 20.0, 7.0)))
    else:
        pairs = [(_harris_response(jnp.asarray(g)), tdet.harris_response(T(g)))]
    tol = 1e-5 if detector == "harris" else 1e-4
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        scale = np.abs(want).max()
        assert scale > 0
        if detector != "harris":
            np.testing.assert_array_equal(got > 0, want > 0)
        assert np.abs(got - want).max() <= tol * scale
