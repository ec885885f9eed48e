"""The streaming runner (`throughput.make_streaming_runner` / `run_streaming`)
against the port's `run_offline` on the same frames and generator seed.

The JAX package holds its streaming runner against its fused offline scan
(`tests/test_throughput.py`); the port's offline runner is already a host
loop, and the streaming runner steps that same runner as frames arrive, so
the estimate stores must be equal exactly (no float32 bound is needed).
The frames are a rendered 10-frame scene (120x160, window 6, overlap 2:
two segments) written in the KITTI layout
(`testing/render.py:write_reference_layout`, PNGs written without cv2) and
read back through `KittiDataset` with the native decoder, as they decode
(`prefetched_frames`), and with `native_loader.PrefetchDecoder` decoding a
segment ahead.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dynosam_tpu_torch.backend.backend import EstimateStore
from dynosam_tpu_torch.data import native_loader
from dynosam_tpu_torch.data.kitti import KittiDataset
from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene, write_reference_layout
from dynosam_tpu_torch.testing.scenes import golden_config
from dynosam_tpu_torch.throughput import make_streaming_runner, run_offline, run_streaming

torch.set_num_threads(2)

N = 10


def _config():
    cfg = golden_config(False)
    return dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, lm_max_iterations=5, opt_window_size=6, opt_window_overlap=2),
        capacity=dataclasses.replace(cfg.capacity, max_frames=N))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    sc = RenderedScene(RenderConfig(n_frames=N, n_objects=2, seed=0, yaw_only_objects=True), device="cpu")
    root = str(tmp_path_factory.mktemp("stream") / "0000")
    write_reference_layout(sc, root)
    ds = KittiDataset(root)
    off = run_offline(list(ds.frames()), ds.camera_params(), _config(), seed=3, device="cpu")
    return sc, root, off


def _assert_same_store(a: EstimateStore, b: EstimateStore):
    for f in EstimateStore._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            assert all(torch.equal(u, v) for u, v in zip(x, y)), f
        else:
            assert torch.equal(x, y), f


def test_streamed_frames_give_the_offline_store(layout):
    sc, root, off = layout
    assert native_loader.available()
    ds = KittiDataset(root)
    res = run_streaming(ds.prefetched_frames(), ds.camera_params(), _config(), N, seed=3, device="cpu")
    _assert_same_store(res.est, off.est)
    assert [float(w.result.error) for w in res.windows] == [float(w.result.error) for w in off.windows]
    assert bool(res.est.X_valid[:N].all())
    gt = np.stack([x.t.numpy() for x in sc.X_gt])
    assert np.sqrt(((res.est.X.t[:N].numpy() - gt) ** 2).sum(1).mean()) < 0.06
    with pytest.raises(ValueError):
        run_streaming(ds.prefetched_frames(), ds.camera_params(), _config(), N + 4, seed=3, device="cpu")


def test_runner_contract_over_the_prefetch_decoder(layout):
    """`(warmup, segment, plan)` driven by hand on frames decoded by the
    native prefetch pool, each segment's PNGs submitted before the previous
    segment runs; the pool's frames equal the loader's decode, and the
    store and window errors equal `run_offline`'s."""
    sc, root, off = layout
    ds = KittiDataset(root)
    warmup, segment, plan = make_streaming_runner(ds.camera_params(), _config(), N, device="cpu", seed=3)
    assert (plan.overlap, plan.stride, plan.n_segments) == (2, 4, 2)
    pool = native_loader.PrefetchDecoder(n_threads=2)
    paths = [f"{root}/{sub}/{k:06d}.png" for k in range(N) for sub in ("image_0", "depth", "motion")]
    for p in paths[:3 * plan.overlap]:
        pool.submit(p)
    frames = {}

    def frame(k):
        if k not in frames:
            frames[k] = ds.frame(k, decode=pool.get)
            for x, y in zip(frames[k], ds.frame(k)):
                assert torch.equal(x, y)
        return frames[k]

    runner = warmup([frame(k) for k in range(plan.overlap)])
    chks = []
    for s in range(plan.n_segments):
        first = plan.overlap + s * plan.stride
        for p in paths[3 * first:3 * (first + plan.stride)]:
            pool.submit(p)
        chks.append(float(segment([frame(k) for k in range(first - 1, first + plan.stride)], s)))
    pool.close()
    _assert_same_store(runner.est, off.est)
    assert chks == [float(w.result.error) for w in off.windows]
    with pytest.raises(ValueError):
        segment([frame(0)], 0)
