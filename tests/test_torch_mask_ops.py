"""Port parity for `frontend/mask_ops.py` (mask propagation, boundaries,
boxes, erosion) and `frontend/imu.py` against the JAX package, and the
tracker's `use_propogate_mask` wiring.

Every mask operation is integer arithmetic on labels, so the port equals
JAX exactly on the same inputs: a rendered frame pair with an object's
label deleted at k (the segmenter losing it), random label fields with
flows that collide and leave the image (JAX clips the rounded targets and
keeps the largest label on a collision), and the shapes of
`tests/test_mask_imu.py`.  The IMU buffer is the port's numpy copy and
gives the same arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.frontend import imu as jimu
from dynosam_tpu.frontend import mask_ops as jmo
from dynosam_tpu_torch.frontend import imu as timu
from dynosam_tpu_torch.frontend import mask_ops as tmo
from dynosam_tpu_torch.frontend.tracker import TrackerState, track_frame
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch.utils.config import TrackerConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rendered():
    sc = RenderedScene(RenderConfig(n_frames=3, h=96, w=128, fx=80.0, n_objects=3, seed=2), device="cpu")
    return sc, sc.frames()


def _lost_pair(rendered):
    """(prev mask, flow k-1 -> k, cur mask with the first object deleted)."""
    sc, frames = rendered
    lab = sc.object_labels[0]
    cur = frames[1].mask.clone()
    cur[cur == lab] = 0
    return frames[0].mask, frames[0].flow, cur, lab


def test_propagate_mask_matches_jax_and_restores_the_lost_object(rendered):
    prev, flow, cur, lab = _lost_pair(rendered)
    got = tmo.propagate_mask(prev, flow, cur)
    want = np.asarray(jmo.propagate_mask(jnp.asarray(prev.numpy()), jnp.asarray(flow.numpy()),
                                         jnp.asarray(cur.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    truth = rendered[1][1].mask
    restored = (got == lab) & (truth == lab)
    assert int(restored.sum()) >= 0.8 * int((truth == lab).sum())
    # labels the segmenter kept are untouched
    kept = cur != 0
    assert torch.equal(got[kept], cur[kept])


@pytest.mark.parametrize("seed", [0, 1])
def test_propagate_mask_collisions_and_clipping_match_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 40, 56
    prev = rng.integers(0, 6, (h, w)).astype(np.int32)
    prev[rng.random((h, w)) < 0.5] = 0
    flow = rng.normal(0, 6, (h, w, 2)).astype(np.float32)
    flow[::3, ::3] = 0.5                      # half-way targets: round half to even
    cur = prev.copy()
    cur[np.isin(cur, [2, 4])] = 0             # two labels lost
    got = tmo.propagate_mask(torch.as_tensor(prev), torch.as_tensor(flow), torch.as_tensor(cur))
    want = jmo.propagate_mask(jnp.asarray(prev), jnp.asarray(flow), jnp.asarray(cur))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boundary_boxes_and_shrink_match_jax(rendered):
    mask = rendered[1][1].mask
    m = jnp.asarray(mask.numpy())
    for th in (1, 2):
        np.testing.assert_array_equal(tmo.mask_boundary(mask, th).numpy(), np.asarray(jmo.mask_boundary(m, th)))
    for cap in (256, 8):
        tb, tc = tmo.object_bboxes(mask, cap)
        jb, jc = jmo.object_bboxes(m, cap)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for e in (0, 1, 3):
        np.testing.assert_array_equal(tmo.shrink_mask(mask, e).numpy(), np.asarray(jmo.shrink_mask(m, e)))
    np.testing.assert_array_equal(tmo.label_counts(mask, 16).numpy(), np.asarray(jmo.label_counts(m, 16)))


def test_track_frame_propagates_the_previous_mask(rendered):
    """With `use_propogate_mask` the tracker works on the propagated mask
    of k (`tracker.py:160-163` of the JAX package): the same state as the
    tracker without the option given that mask, and the lost object keeps
    its slot and dynamic tracks."""
    sc, frames = rendered
    prev, flow, cur, lab = _lost_pair(rendered)
    cfg = TrackerConfig(max_features_per_frame=200, klt_window=13, klt_levels=2)
    st = TrackerState.create(256, 512, 8)
    st, _ = track_frame(st, frames[0].gray, frames[0].gray, frames[0].flow, frames[0].mask, cfg,
                        first_frame=True, generator=torch.Generator().manual_seed(0))
    args = (st, frames[0].gray, frames[1].gray, frames[0].flow)
    on, _ = track_frame(*args, cur, dataclasses.replace(cfg, use_propogate_mask=True),
                        generator=torch.Generator().manual_seed(1), mask_prev=prev)
    ref, _ = track_frame(*args, tmo.propagate_mask(prev, flow, cur), cfg, generator=torch.Generator().manual_seed(1))
    off, _ = track_frame(*args, cur, cfg, generator=torch.Generator().manual_seed(1))
    for f in TrackerState._fields:
        assert torch.equal(getattr(on, f), getattr(ref, f)), f
    slot = int(torch.nonzero(on.obj_labels == lab)[0])
    assert int(((on.d_obj == slot) & on.d_active).sum()) > int(((off.d_obj == slot) & off.d_active).sum())


def test_imu_buffer_matches_jax():
    bufs = [timu.ImuBuffer(capacity=6), jimu.ImuBuffer(capacity=6)]
    for buf, mod in zip(bufs, (timu, jimu)):
        for k in range(10):
            buf.add(mod.ImuMeasurement(k * 0.01, np.array([k, 0.0, 9.8]), np.array([0.0, k * 0.1, 0])))
        with pytest.raises(ValueError):
            buf.add(mod.ImuMeasurement(0.0, np.zeros(3), np.zeros(3)))
    t, j = bufs
    assert len(t) == len(j) == 6
    for q in (0.045, 0.06, 0.0901, 1.0, 0.01):
        a, b = t.interpolate(q), j.interpolate(q)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.accel, b.accel)
            np.testing.assert_array_equal(a.gyro, b.gyro)
    for got, want in zip(t.between(0.045, 0.085), j.between(0.045, 0.085)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(t.between(0.045, 0.085)[1][0, 0], 4.5)
