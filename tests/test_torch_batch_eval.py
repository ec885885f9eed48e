"""The port's multi-sequence pipeline (`dynosam_tpu_torch/parallel/batch_eval.py`)
at `tests/test_batch_eval.py:19-43`'s size (two rendered sequences of 4
frames 160x120, seeds 0 and 1, 200 features), on a one-rank gloo group's
mesh (`testing.gloo.run_ranks`).

* Each sequence's packets equal, bit for bit, the port's single-sequence
  `frontend_step` run of the same frames with the same per-frame
  generators (that run is held against JAX by the frontend parity tests;
  JAX's own multi-sequence test is `slow`);
* last-frame camera error below 0.08 m and more than 30 static
  observations per sequence (`tests/test_batch_eval.py:37-43`).
"""

from pathlib import Path

import torch

from dynosam_tpu_torch.testing.gloo import run_ranks

ROOT = Path(__file__).resolve().parent.parent
PYPATH = [str(ROOT), str(ROOT / "tests")]


def scenes_and_config():
    from dynosam_tpu_torch.testing.render import RenderConfig, RenderedScene
    from dynosam_tpu_torch.testing.scenes import RenderedDataset
    from dynosam_tpu_torch.utils.config import FrontendConfig, TrackerConfig

    scenes = [RenderedScene(RenderConfig(n_frames=4, seed=s), device="cpu") for s in (0, 1)]
    cfg = FrontendConfig(tracker=TrackerConfig(max_features_per_frame=200, klt_window=11, klt_levels=2),
                         min_dynamic_features_per_object=20, refine_motion_with_3d=False)
    return scenes, [RenderedDataset(s) for s in scenes], cfg


def batch_rank(rank, world):
    """The batched run, then each sequence alone through `frontend_step`
    with the same generators, in the same process (same thread count)."""
    from dynosam_tpu_torch.frontend.frontend import FrontendState, frontend_step
    from dynosam_tpu_torch.parallel.batch_eval import MultiSequencePipeline, frame_generator
    from dynosam_tpu_torch.parallel.mesh import make_mesh

    _, datasets, cfg = scenes_and_config()
    pipe = MultiSequencePipeline(datasets, cfg, caps=(256, 512, 8), mesh=make_mesh(1), device="cpu")
    batched = pipe.run(4)
    single = []
    for s, ds in enumerate(datasets):
        state, prev, run = FrontendState.create(256, 512, 8, device="cpu"), None, []
        for k, f in enumerate(ds.frames()):
            state, pkt, _, _ = frontend_step(state, prev if prev is not None else f, f, ds.camera_params(), cfg,
                                             generator=frame_generator(k, s, "cpu"), first_frame=k == 0,
                                             device="cpu")
            prev = f
            run.append(pkt)
        single.append(run)
    return {"sequences": pipe.sequences, "packets": batched, "single": single}


def test_multi_sequence_batch_matches_single_sequence_runs():
    from dynosam_tpu_torch.core.lie import SE3, se3_local

    out = run_ranks("test_torch_batch_eval:batch_rank", 1, {}, 240, PYPATH)[0]
    assert out["sequences"] == [0, 1]
    packets = out["packets"]
    assert len(packets) == 4
    scenes, _, _ = scenes_and_config()
    last = packets[-1]
    for s, scene in enumerate(scenes):
        X = SE3(last.X_world.R[s], last.X_world.t[s])
        assert float(se3_local(scene.X_gt[3], X)[3:].norm()) < 0.08, s
        assert int(last.static_obs.valid[s].sum()) > 30
        for k, pkt in enumerate(out["single"][s]):
            got = torch.utils._pytree.tree_leaves(packets[k])
            want = torch.utils._pytree.tree_leaves(pkt)
            assert len(got) == len(want)
            assert all(torch.equal(a[s], b) for a, b in zip(got, want)), (s, k)
