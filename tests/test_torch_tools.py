"""The port's tools (`dynosam_tpu_torch/utils/histogram.py`, `utils/debug.py`,
`viz/visualizer.py`, `eval/plotting.py`, the `display` hook of
`pipeline.DynoPipeline`) against the JAX package's on the same numpy
inputs (`tests/test_tools.py:47-57,84-163`, `tests/test_eval.py:106-183`).

Images, tables and report files equal JAX's exactly (the visualizer takes
tensors and moves them to the host); the PDF report is checked for size,
as JAX's test does.  `nan_debug` must name the operator that made a NaN.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch


def test_histogram_matches_jax():
    from dynosam_tpu.utils.histogram import Histogram as JHistogram
    from dynosam_tpu_torch.utils.histogram import Histogram

    values = [-1, 0.5, 0.7, 1.5, 4.9, 5.0, 100]
    j, t = JHistogram([0, 1, 2, 5], name="t"), Histogram([0, 1, 2, 5], name="t")
    j.add_all(values)
    t.add_all(torch.tensor(values))
    t.add(3.0)
    j.add(3.0)
    assert t.to_dict() == j.to_dict() and str(t) == str(j) and t.total == j.total == 8
    assert (t.underflow, t.overflow) == (1, 2)
    for v in (0.5, -3, 7, 1.0, 5.0):
        assert t.bin_of(v) == j.bin_of(v)
    with pytest.raises(ValueError):
        Histogram([1.0])


@pytest.fixture
def viz_inputs(rng):
    gray = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    mask = np.zeros((60, 80), np.int32)
    mask[10:30, 20:50] = 3
    mask[40:55, 5:15] = 1
    uv = rng.uniform(0, [79, 59], size=(10, 2)).astype(np.float32)
    prev = (uv + rng.normal(0, 2, uv.shape)).astype(np.float32)
    valid = rng.random(10) > 0.3
    obj = rng.integers(-1, 3, 10).astype(np.int32)
    flow = rng.normal(0, 3, (60, 80, 2)).astype(np.float32)
    depth = rng.uniform(0, 40, (60, 80)).astype(np.float32)
    return dict(gray=gray, mask=mask, uv=uv, prev=prev, valid=valid, obj=obj, flow=flow, depth=depth)


def test_visualizer_matches_jax(viz_inputs, tmp_path):
    from dynosam_tpu.viz import visualizer as jv
    from dynosam_tpu_torch.viz import visualizer as tv

    x = viz_inputs
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    img = jv.gray_to_bgr(x["gray"])
    np.testing.assert_array_equal(tv.gray_to_bgr(t["gray"]), img)
    np.testing.assert_array_equal(tv.overlay_mask(torch.as_tensor(img), t["mask"]), jv.overlay_mask(img, x["mask"]))
    np.testing.assert_array_equal(tv.draw_tracks(img, t["uv"], t["valid"], prev_uv=t["prev"]),
                                  jv.draw_tracks(img, x["uv"], x["valid"], prev_uv=x["prev"]))
    np.testing.assert_array_equal(tv.draw_object_tracks(img, t["uv"], t["obj"], t["valid"]),
                                  jv.draw_object_tracks(img, x["uv"], x["obj"], x["valid"]))
    np.testing.assert_array_equal(tv.flow_to_bgr(t["flow"]), jv.flow_to_bgr(x["flow"]))
    np.testing.assert_array_equal(tv.flow_to_bgr(t["flow"], max_mag=4.0), jv.flow_to_bgr(x["flow"], max_mag=4.0))
    np.testing.assert_array_equal(tv.depth_to_bgr(t["depth"]), jv.depth_to_bgr(x["depth"]))

    def packet(mod):
        s = SimpleNamespace(uv=mod(x["uv"]), valid=mod(x["valid"]))
        d = SimpleNamespace(uv=mod(x["uv"][::-1].copy()), obj=mod(x["obj"]), valid=mod(x["valid"][::-1].copy()))
        return SimpleNamespace(static_obs=s, dynamic_obs=d)

    images = SimpleNamespace(gray=x["gray"], mask=x["mask"])
    timages = SimpleNamespace(gray=t["gray"], mask=t["mask"])
    np.testing.assert_array_equal(tv.frontend_debug_image(timages, packet(torch.as_tensor), prev_uv_s=t["prev"]),
                                  jv.frontend_debug_image(images, packet(np.asarray), prev_uv_s=x["prev"]))
    jd = jv.FrontendDisplay(video_path=str(tmp_path / "j.avi"))
    td = tv.FrontendDisplay(video_path=str(tmp_path / "t.avi"))
    for _ in range(2):
        np.testing.assert_array_equal(td.spin_once(timages, packet(torch.as_tensor)),
                                      jd.spin_once(images, packet(np.asarray)))
    jd.close()
    td.close()
    assert os.path.getsize(tmp_path / "t.avi") == os.path.getsize(tmp_path / "j.avi") > 0


def _write_logs(tmp_path, rng, name, prefix, n, objects):
    from dynosam_tpu_torch.utils.logger import EstimationLogger
    from test_eval import random_traj

    gt = random_traj(rng, n=n)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(size=(n, 3)) * 0.02
    d = tmp_path / name
    d.mkdir()
    log = EstimationLogger(str(d), prefix)
    for k in range(n):
        log.log_camera_pose(k, est[k], gt[k])
        log.log_timestamp(k, k * 0.1)
    for k in objects:
        log.log_object_motion(k, 3, est[k], gt[k])
        log.log_object_pose(k, 3, est[k], gt[k])
    log.flush()
    return str(d)


def test_plotting_tables_and_reports_match_jax(tmp_path, rng):
    from dynosam_tpu.eval import plotting as jp
    from dynosam_tpu.eval.evaluator import evaluate_all as jevaluate_all
    from dynosam_tpu_torch.eval import plotting as tp
    from dynosam_tpu_torch.eval.evaluator import evaluate_all

    runs = [_write_logs(tmp_path, rng, name, "rgbd_backend", 8, range(1, 8)) for name in ("runA", "runB")]
    results = evaluate_all(runs[0])
    jresults = jevaluate_all(runs[0])
    assert tp.results_table_markdown(results) == jp.results_table_markdown(jresults)
    tex = tp.results_table_latex(results)
    assert tex == jp.results_table_latex(jresults)
    assert r"\begin{tabular}{|c|cc|cc|}" in tex and "\n3 & " in tex
    path = tp.write_result_tables(runs[0], results)
    assert open(path).read() == tex
    evaluate_all(runs[1])
    t_sum = tp.aggregate_runs(runs, str(tmp_path / "t.json"))
    j_sum = jp.aggregate_runs(runs, str(tmp_path / "j.json"))
    assert t_sum["tables"] == j_sum["tables"]
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    pdf = tp.make_report(runs[0], results)
    assert os.path.exists(pdf) and os.path.getsize(pdf) > 1000


def test_check_finite_and_nan_debug():
    from dynosam_tpu_torch.core.lie import SE3
    from dynosam_tpu_torch.utils import debug

    good = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}, "pose": SE3(torch.eye(3), torch.zeros(3))}
    assert debug.check_finite(good)
    with pytest.raises(FloatingPointError, match=r"state\['a'\]: 1 non-finite"):
        debug.check_finite({"a": torch.tensor([1.0, float("nan")])}, "state")
    with pytest.raises(FloatingPointError, match=r"\['pose'\]\.t"):
        debug.check_finite({"pose": SE3(torch.eye(3), torch.tensor([0.0, float("inf"), 0.0]))})
    x = torch.tensor([4.0, -1.0])
    with pytest.raises(FloatingPointError, match="aten.log"):
        with debug.nan_debug():
            torch.log(x)
    with debug.nan_debug():
        y = torch.sqrt(x.abs())
    assert torch.equal(y, torch.tensor([2.0, 1.0]))


def test_deterministic_replay_of_the_frontend_step(rng):
    """The whole frontend step is bit-deterministic (`tests/test_tools.py:128-163`,
    the port's `frontend_step` with a generator seeded the same way)."""
    from dynosam_tpu_torch import convert
    from dynosam_tpu_torch.frontend.frontend import FrameImages, FrontendState, frontend_step
    from dynosam_tpu_torch.utils.config import FrontendConfig, TrackerConfig
    from dynosam_tpu_torch.utils.debug import deterministic_replay

    r = np.random.default_rng(3)
    h, w = 64, 96
    cam = convert.camera_from_numpy(dict(fx=80.0, fy=80.0, cx=48.0, cy=32.0, width=w, height=h))
    cfg = FrontendConfig(tracker=TrackerConfig(max_features_per_frame=50, klt_window=9, klt_levels=2))
    img = FrameImages(gray=torch.as_tensor(r.uniform(0, 255, (h, w)).astype(np.float32)),
                      depth=torch.as_tensor(r.uniform(2, 20, (h, w)).astype(np.float32)),
                      flow=torch.zeros((h, w, 2)), mask=torch.zeros((h, w), dtype=torch.int32))
    st = FrontendState.create(64, 64, 4, device="cpu")

    def step():
        g = torch.Generator().manual_seed(0)
        return frontend_step(st, img, img, cam, cfg, generator=g, first_frame=True, device="cpu")[1]

    out = deterministic_replay(step)
    assert out[".X_world.t"].shape == (3,)
    assert deterministic_replay(lambda x: torch.cumsum(x * 2, 0), torch.as_tensor(rng.normal(size=32))).shape == (32,)
    calls = iter([torch.zeros(2), torch.tensor([0.0, 1e-9])])
    with pytest.raises(AssertionError):
        deterministic_replay(lambda: next(calls))


def test_pipeline_display_hook_sees_every_frame():
    """`DynoPipeline(display=...)` calls `spin_once(images, packet)` once per
    frame and `close()` once at the end of `run`, as JAX's pipeline does."""
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.utils.config import CapacityConfig, DynoConfig, PipelineConfig

    class Recorder:
        def __init__(self):
            self.frames, self.closed = [], 0

        def spin_once(self, images, packet):
            self.frames.append((images.gray.shape, int(packet.frame_id)))

        def close(self):
            self.closed += 1

    scene = RenderedScene(RenderConfig(n_frames=3, h=48, w=64, fx=48.0), device="cpu")
    cfg = DynoConfig(pipeline=PipelineConfig(use_backend=False),
                     capacity=CapacityConfig(max_static_tracks=64, max_dynamic_tracks=128, max_objects=4))
    rec = Recorder()
    DynoPipeline(scene.cam, cfg, device="cpu", display=rec).run(scene.frames())
    assert rec.frames == [((48, 64), k) for k in range(3)]
    assert rec.closed == 1
