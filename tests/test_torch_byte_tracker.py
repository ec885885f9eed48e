"""Port parity for `frontend/byte_tracker.py` (the port's numpy copy of the
JAX package's ByteTrack association) and its wiring into `DynoPipeline`
(`use_byte_tracker`).

The tracker is host numpy on both sides, so the port must give the same
ids, boxes and relabelled masks exactly: on the cases of
`tests/test_byte_tracker.py` and on a rendered sequence whose instance ids
are permuted on every frame.  The pipeline relabels each frame's mask on
the host before the frame goes to its device; its packets equal those of
the pipeline without the option fed the JAX package's relabelled masks.
"""

import dataclasses

import numpy as np
import torch

from dynosam_tpu.frontend import byte_tracker as jbt
from dynosam_tpu_torch.frontend import byte_tracker as tbt
from dynosam_tpu_torch.pipeline import DynoPipeline
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch.testing.scenes import golden_config

torch.set_num_threads(2)


def _permuted(frames, seed=0):
    """The frames with their instance ids permuted (to 11..) on every frame."""
    rng = np.random.default_rng(seed)
    out = []
    for f in frames:
        m = f.mask.numpy()
        labels = [int(x) for x in np.unique(m) if x > 0]
        new = rng.permutation(len(labels)) + 11
        pm = np.zeros_like(m)
        for lab, nl in zip(labels, new):
            pm[m == lab] = nl
        out.append(f._replace(mask=torch.as_tensor(pm)))
    return out


def test_hungarian_iou_and_tracker_match_jax():
    cost = np.random.default_rng(0).random((5, 4))
    assert tbt.hungarian(cost) == jbt.hungarian(cost)
    a = np.array([[0, 0, 10, 10], [3, 4, 20, 9]], np.float64)
    b = np.array([[5, 5, 15, 15], [20, 20, 30, 30], [0, 0, 10, 10]], np.float64)
    np.testing.assert_array_equal(tbt.iou(a, b), jbt.iou(a, b))
    trackers = [tbt.ByteTracker(max_missed=2), jbt.ByteTracker(max_missed=2)]
    rng = np.random.default_rng(1)
    for k in range(8):
        n = 0 if k in (3, 4) else 3
        boxes = np.array([[10 + 3 * k, 10, 40 + 3 * k, 40], [100 + 3 * k, 50, 140 + 3 * k, 90],
                          [60, 5 + 2 * k, 80, 30 + 2 * k]], np.float64)[:n]
        scores = rng.uniform(0.2, 1.0, n)
        ids = [tr.update(boxes, scores) for tr in trackers]
        assert ids[0] == ids[1]
        for ta, tb in zip(trackers[0].tracks, trackers[1].tracks):
            assert ta.track_id == tb.track_id and ta.missed == tb.missed
            np.testing.assert_array_equal(ta.kf.x, tb.kf.x)
            np.testing.assert_array_equal(ta.kf.P, tb.kf.P)


def test_relabel_mask_gives_consistent_ids_as_jax():
    sc = RenderedScene(RenderConfig(n_frames=6, h=96, w=128, fx=80.0, n_objects=3, seed=3), device="cpu")
    frames = _permuted(sc.frames())
    trackers = [tbt.ByteTracker(), jbt.ByteTracker()]
    ids_per_object = {lab: set() for lab in sc.object_labels}
    for f, src in zip(frames, sc.frames()):
        m = f.mask.numpy()
        t = tbt.relabel_mask(trackers[0], m, score_pixel_norm=200.0)
        j = jbt.relabel_mask(trackers[1], m, score_pixel_norm=200.0)
        np.testing.assert_array_equal(t, j)
        assert t.dtype == m.dtype
        for lab in sc.object_labels:
            ids_per_object[lab] |= set(np.unique(t[src.mask.numpy() == lab]).tolist())
        lt, bt, ct = tbt.mask_boxes(m)
        lj, bj, cj = jbt.mask_boxes(m)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(ct, cj)
    assert all(len(v) == 1 for v in ids_per_object.values()), ids_per_object
    assert len({next(iter(v)) for v in ids_per_object.values()}) == len(ids_per_object)


def test_pipeline_relabels_on_the_host_before_the_step():
    sc = RenderedScene(RenderConfig(n_frames=4, n_objects=2, seed=0), device="cpu")
    frames = _permuted(sc.frames(), seed=5)
    cfg = golden_config(True)
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline, use_backend=False))
    on = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, tracker=dataclasses.replace(cfg.frontend.tracker, use_byte_tracker=True)))
    got = DynoPipeline(sc.cam, on, device="cpu").run(frames).packets
    jt = jbt.ByteTracker()
    relabelled = [f._replace(mask=torch.as_tensor(jbt.relabel_mask(jt, f.mask.numpy()))) for f in frames]
    want = DynoPipeline(sc.cam, cfg, device="cpu").run(relabelled).packets
    for a, b in zip(got, want):
        assert torch.equal(a.objects.label, b.objects.label)
        assert torch.equal(a.X_world.t, b.X_world.t)
        assert torch.equal(a.dynamic_obs.obj, b.dynamic_obs.obj)
    assert sorted(int(x) for x in got[-1].objects.label if x >= 0) == [1, 2]
