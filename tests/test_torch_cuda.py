"""Card-only checks of the port: each Hopper kernel against its plain
PyTorch version on the same CUDA tensors, and a short frontend-only run
that must launch every kernel on every steady frame.

Marked `cuda`; a fixture skips them where no card is present.  On a machine
with a card and the CUDA toolkit (this file imports neither JAX nor the
repository's conftest):

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" --noconftest -q
"""

import numpy as np
import pytest
import torch

from dynosam_tpu_torch import kernels
from dynosam_tpu_torch.kernels import lk, point_sample, response

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.fixture
def frames(cuda):
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene

    return RenderedScene(RenderConfig(n_frames=4, h=192, w=256, n_objects=2), device=cuda).frames()


def test_k1_lk_level_matches_plain(cuda, frames):
    """K1 against its plain version: 0.05 px on g, 0.1 grey levels on err
    (block-reduction order; the eps stop may fall one step apart)."""
    rng = np.random.default_rng(0)
    n = 300
    p = torch.as_tensor(rng.uniform([12, 12], [244, 180], (n, 2)).astype(np.float32), device=cuda)
    valid = torch.as_tensor(rng.random(n) > 0.4, device=cuda)
    g0 = torch.as_tensor(rng.normal(0, 1, (n, 2)).astype(np.float32), device=cuda)
    f0, f1 = frames[0], frames[1]
    for win, iters, eps in ((21, 10, 0.01), (13, 30, 0.0)):
        kernels.reset_launch_counts()
        g, err = lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
        gp, ep = lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["lk"] == 1
        assert float((g - gp).abs().max()) < 0.05
        assert float((err - ep).abs().max()) < 0.1
        assert torch.equal(g[~valid], g0[~valid]) and bool((err[~valid] == 0).all())


def test_k2_point_sample_matches_plain(cuda, frames):
    """K2 against its plain version: bilinear to 1e-5 of max |value|,
    nearest exactly, invalid rows 0, half-way coordinates rounding to
    even."""
    f = frames[1]
    rng = np.random.default_rng(1)
    uv = rng.uniform([-3, -3], [259, 195], (1000, 2)).astype(np.float32)
    uv[:4] = [[6.5, 3.5], [7.5, 8.5], [0.5, 0.5], [255.0, 191.0]]
    uv = torch.as_tensor(uv, device=cuda)
    valid = torch.as_tensor(rng.random(1000) > 0.3, device=cuda)
    valid[:4] = True
    stack = torch.stack([f.depth, f.mask.float(), f.gray]).contiguous()
    modes = ("bilinear", "nearest", "bilinear")
    got = point_sample.point_sample(stack, uv, modes, valid)
    want = point_sample.point_sample_plain(stack, uv, modes, valid)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 1], want[:, 1])
    for c in (0, 2):
        assert float((got[:, c] - want[:, c]).abs().max()) <= 1e-5 * float(want[:, c].abs().max())
    assert bool((got[~valid] == 0).all())
    idx = torch.tensor([[6, 4], [8, 8], [0, 0]], device=cuda)   # (x, y): 6.5->6, 3.5->4, 8.5->8, 0.5->0
    assert torch.equal(got[:3, 1], f.mask.float()[idx[:, 1], idx[:, 0]])


def test_k3_response_matches_plain(cuda, frames):
    """K3 against its plain version on the whole image, borders included:
    1e-5 of max |response|."""
    g = frames[0].gray
    got = response.shi_tomasi_response(g)
    want = response.shi_tomasi_response_plain(g)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_pipeline_launches_every_kernel_on_every_steady_frame(cuda, frames):
    """Four frames of the frontend-only pipeline on the card: finite poses,
    and K1, K2 and K3 each launched on every frame after the first."""
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.utils.config import CapacityConfig, DynoConfig, PipelineConfig

    scene = RenderedScene(RenderConfig(n_frames=4, h=192, w=256, n_objects=2), device=cuda)
    cfg = DynoConfig(pipeline=PipelineConfig(use_backend=False),
                     capacity=CapacityConfig(max_static_tracks=512, max_dynamic_tracks=1024, max_objects=8))
    pipe = DynoPipeline(scene.cam, cfg)
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    for k, f in enumerate(scene.frames()):
        pkt = pipe.spin_once(f)
        now = kernels.launch_counts()
        if k > 0:
            assert all(now[name] > prev[name] for name in now), (k, prev, now)
        prev = now
    torch.cuda.synchronize()
    assert bool(torch.isfinite(pkt.X_world.t).all())
    assert pkt.X_world.t.device.type == "cuda"
