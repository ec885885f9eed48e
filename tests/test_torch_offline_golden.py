"""The port's offline pipeline as a whole on the CPU:
`dynosam_tpu_torch.throughput.run_offline(device="cpu")` over the golden
scene's first 28 frames (4 + 4 x 6: four window solves) with the golden
config's frontend and sliding windows must give a backend camera ATE
under 0.06 m (the port's `eval.metrics.ate`), the sliding-window band of
`tests/test_accuracy_regression.py::test_sliding_vs_batch_ordering`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.eval import metrics
from dynosam_tpu_torch import throughput as ttp
from dynosam_tpu_torch.frontend.frontend import FrameImages

from test_torch_throughput import golden_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden_frames():
    """The golden scene of `tests/test_accuracy_regression.py` with its
    noise recipe (0.5 px flow, 1 % depth from numpy seed 1), first 28 frames."""
    scene = RenderedScene(RenderConfig(n_frames=32, n_objects=2, seed=0))
    fr = np.random.default_rng(1)
    frames = []
    for f in scene.frames():
        depth = f.depth * (1.0 + jnp.asarray(fr.normal(0, 0.01, np.asarray(f.depth).shape), jnp.float32))
        flow = f.flow + jnp.asarray(fr.normal(0, 0.5, np.asarray(f.flow).shape), jnp.float32)
        frames.append(FrameImages(*(torch.as_tensor(np.array(x)) for x in (f.gray, depth, flow, f.mask))))
    return scene, frames[:28]


def _poses(R, t):
    T = np.zeros((len(t), 4, 4))
    T[:, 3, 3] = 1
    T[:, :3, :3] = np.asarray(R)
    T[:, :3, 3] = np.asarray(t)
    return T


def test_run_offline_golden_backend_ate(golden_frames):
    scene, frames = golden_frames
    n = len(frames)
    cam = convert.camera_from_numpy(scene.cam._asdict())
    out = ttp.run_offline(frames, cam, golden_config(n), device="cpu")
    assert len(out.packets) == n
    assert [w.start for w in out.windows] == [0, 6, 12, 18]
    for w in out.windows:
        r = w.result
        assert np.isfinite(float(r.error)) and float(r.error) < float(r.initial_error)
    assert bool(out.est.X_valid[:n].all())
    est = _poses(out.est.X.R[:n].numpy(), out.est.X.t[:n].numpy())
    gt = _poses([np.asarray(x.R) for x in scene.X_gt[:n]], [np.asarray(x.t) for x in scene.X_gt[:n]])
    assert metrics.ate(est, gt)["trans"].rmse < 0.06
