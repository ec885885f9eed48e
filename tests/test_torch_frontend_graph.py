"""The frontend step as stretches between its host reads
(`frontend/frontend.py`: `_variants`, `_schedule`, `_FrameGraphs`), which
the card captures as CUDA graphs, here on the CPU:

- the step over fixed buffers, each stretch replayed as it was captured
  (the capture replaced by eager replays of the captured functions),
  equals the eager step bit for bit over 8 frames of the golden scene;
- the uniforms drawn before the step give the hypotheses the generator
  gives inside it, and leave the generator where it leaves it;
- the homography RANSAC's selection of its best hypothesis on the device
  equals Python indexing by the argmax;
- a steady frame, in each configuration the card graphs, reads the host
  only where the design leaves a read: the homography refit's `eigh` (a
  read on the card), in its own eager stretch, and on the CPU the round
  and LM flags of the refinements' plain version (the host loops K5
  replaces on the card), inside the stretch `rest`;
- the capture cache's key changes when a module function a stretch calls
  is replaced.

No JAX here: the step's parity with the JAX package is held by
`tests/test_torch_frontend.py` and `tests/test_torch_pipeline.py`.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynosam_tpu_torch.frontend import frontend as fe
from dynosam_tpu_torch.frontend import refine
from dynosam_tpu_torch.frontend.frontend import FrontendState, frontend_step
from dynosam_tpu_torch.ops import homography, ransac
from dynosam_tpu_torch.testing.scenes import golden_config, golden_dataset
from dynosam_tpu_torch.utils import graphs

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_FRAMES = 8
leaves = torch.utils._pytree.tree_leaves


class Replay:
    """A captured stretch whose replay runs the function it was captured
    from, over the same fixed buffers."""

    def __init__(self, fn):
        self.replay = fn


def fake_capture(variants, device, warmups=2):
    """`graphs.capture` without the card: no warm-ups (they make the card's
    library handles), each replay an eager call."""
    return {name: Replay(fn) for name, fn in variants.items()}


@pytest.fixture(scope="module")
def golden():
    ds = golden_dataset(CPU)
    cfg = golden_config(False)
    return ds.camera_params(), cfg, [ds.frame(i) for i in range(N_FRAMES)]


def _state(cfg):
    cap = cfg.capacity
    return FrontendState.create(cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects, device=CPU)


def _inputs(state, prev, images, cfg, first, generator):
    return dict(state=state, prev=prev, images=images,
                u=fe._draw_uniforms(state, cfg.frontend, first, generator, CPU))


def _equal(a, b) -> bool:
    la, lb = leaves(tuple(a)), leaves(tuple(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def frame_one(golden):
    """(settings, inputs) of frame 1's step after an eager frame 0."""
    cam, cfg, frames = golden
    g = torch.Generator().manual_seed(0)
    state = frontend_step(_state(cfg), frames[0], frames[0], cam, cfg.frontend, generator=g, first_frame=True,
                          device=CPU)[0]
    return fe._step_settings(cam, cfg.frontend, True, False, g), _inputs(state, frames[0], frames[1], cfg, False, g)


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(graphs, "capture", fake_capture)
    monkeypatch.setattr(fe, "_FRAME_GRAPHS", type(fe._FRAME_GRAPHS)())


def test_replayed_stretches_equal_the_eager_step_bit_for_bit(golden, fresh_cache):
    """Frame 0 runs eagerly on both sides; from frame 1 on, one capture
    serves every frame and each frame replays the same stretches (2:
    tracking and the rest; the `eigh` between them runs eagerly), each
    frame's outputs cloned out of the buffers."""
    cam, cfg, frames = golden
    assert fe.graphable(cfg.frontend)
    st_e = st_g = _state(cfg)
    g_e, g_g = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    counts = graphs.counts("frontend")
    held = []
    for k, f in enumerate(frames):
        prev = frames[max(k - 1, 0)]
        out_e = frontend_step(st_e, prev, f, cam, cfg.frontend, generator=g_e, first_frame=k == 0, device=CPU)
        c = fe._step_settings(cam, cfg.frontend, True, k == 0, g_g)
        inputs = _inputs(st_g, prev, f, cfg, k == 0, g_g)
        out_g = fe._run_eagerly({"in": inputs}, c)["out"] if k == 0 else fe._captured_step(inputs, c).step(inputs)
        assert _equal(out_g, out_e), k
        held.append((graphs.tree_clone(out_g), out_g))
        st_e, st_g = out_e[0], out_g[0]
    assert torch.equal(g_e.get_state(), g_g.get_state())
    # a frame's outputs are its own: later replays left them as they were
    assert all(_equal(a, b) for a, b in held)
    now = graphs.counts("frontend")
    assert now["captures"] == counts["captures"] + 1
    assert now["replays"] - counts["replays"] == 2 * (N_FRAMES - 1)


def test_uniforms_drawn_beforehand_give_the_generators_hypotheses():
    gen = torch.Generator().manual_seed(3)
    valid = torch.rand((2, 300), generator=gen) > 0.4
    a, b = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    idx_a = ransac.sample_valid_indices(valid, 500, 3, a)
    idx_b = ransac.sample_valid_indices(valid, 500, 3, uniforms=ransac.draw_uniforms((2,), 500, 3, b, CPU))
    assert torch.equal(idx_a, idx_b) and torch.equal(a.get_state(), b.get_state())
    p = torch.rand((300, 2), generator=gen) * 100
    q = p + 0.5 * torch.randn((300, 2), generator=gen)
    ha = homography.ransac_homography(p, q, valid[0], iters=128, generator=a)
    hb = homography.ransac_homography(p, q, valid[0], iters=128, uniforms=ransac.draw_uniforms((), 128, 4, b, CPU))
    assert all(torch.equal(x, y) for x, y in zip(ha, hb)) and torch.equal(a.get_state(), b.get_state())


def test_device_side_selection_equals_indexing_by_the_argmax():
    gen = torch.Generator().manual_seed(5)
    p = torch.rand((200, 2), generator=gen) * 100
    q = p @ torch.tensor([[1.01, 0.02], [-0.01, 0.99]]) + 3.0 + torch.randn((200, 2), generator=gen)
    valid = torch.rand((200,), generator=gen) > 0.2
    idx = ransac.sample_valid_indices(valid, 64, 4, torch.Generator().manual_seed(1)).long()
    head = homography.ransac_homography_head(p, q, valid, iters=64, threshold=3.0, idx=idx)
    Hs = homography.homography_from_points(p[idx], q[idx], method="solve")
    inl = (homography.transfer_error(Hs, p[None], q[None]) < 3.0) & valid[None]
    scores = torch.sum(inl, dim=-1)
    best = int(torch.argmax(scores))
    assert torch.equal(head.inl_best, inl[best]) and torch.equal(head.score_best, scores[best])
    assert torch.equal(head.H_best, Hs[best])


# operators that read the host on the card, and `lift_fresh`: a tensor made
# from host data (also a Python scalar assigned by indexing), which the card
# copies from pageable memory
HOST_OPS = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.nonzero", "aten._linalg_eigh",
            "aten.lift_fresh")


class HostOps(TorchDispatchMode):
    """Records each host-reading operator with the stretch open at the
    time (None between stretches)."""

    def __init__(self):
        super().__init__()
        self.stretch, self.seen = None, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_OPS):
            self.seen.append((str(func).split(".")[1], self.stretch))
        return func(*args, **(kwargs or {}))


def _variant(cfg, **tracker):
    """`cfg` with its frontend's tracker fields or, for "ego", its ego-motion
    solver replaced."""
    fe_cfg = cfg.frontend
    if "ego" in tracker:
        fe_cfg = dataclasses.replace(fe_cfg, ego_motion_solver=tracker.pop("ego"))
    fe_cfg = dataclasses.replace(fe_cfg, tracker=dataclasses.replace(fe_cfg.tracker, **tracker))
    return dataclasses.replace(cfg, frontend=fe_cfg)


@pytest.mark.parametrize("setting", [{}, {"feature_detector_type": "orb", "orb_reassociate": True}, {"ego": "3d3d"},
                                     {"use_propogate_mask": True}], ids=["default", "orb", "3d3d", "propagate"])
def test_a_steady_frame_reads_the_host_only_where_the_design_does(golden, setting, monkeypatch):
    """Frame 1 of the golden scene in each configuration the card graphs:
    no read between stretches, the homography refit's `eigh` the one read
    in its stretch, and in `rest` only the flags the refinements' host
    loops read (one per `more` call of each refinement's
    `refine.rounds_schedule`: the CPU's plain version of K5, one launch
    with no read on the card); no stretch copies host data; the F.one_hot
    range checks, Python indexing by 0-d tensors and Python scalars
    assigned by indexing are gone."""
    cam, cfg, frames = golden
    cfg = _variant(cfg, **setting)
    assert fe.graphable(cfg.frontend)
    g = torch.Generator().manual_seed(0)
    state = frontend_step(_state(cfg), frames[0], frames[0], cam, cfg.frontend, generator=g, first_frame=True,
                          device=CPU)[0]
    c = fe._step_settings(cam, cfg.frontend, True, False, g)
    s = {"in": _inputs(state, frames[0], frames[1], cfg, False, g)}
    variants, flags, loops, mode = fe._variants(c), [], [], HostOps()
    real = refine.rounds_schedule

    def rounds_schedule(run, more, max_iterations):
        loops.append(max_iterations)

        def counted(name):
            flags.append(name)
            return more(name)

        return real(run, counted, max_iterations)

    monkeypatch.setattr(refine, "rounds_schedule", rounds_schedule)

    def run(name):
        mode.stretch = name
        s.update(variants[name](s))
        mode.stretch = None

    with mode:
        fe._schedule(run, c)
    assert [op for op, st in mode.seen if st is None] == []
    assert [op for op, st in mode.seen if st == "eigh"] == ["_linalg_eigh"] and fe._EAGER == ("eigh",)
    in_rest = [op for op, st in mode.seen if st == "rest"]
    assert {st for _, st in mode.seen} <= {"eigh", "rest"}
    assert len(in_rest) == len(flags) and set(in_rest) <= {"_local_scalar_dense", "is_nonzero", "item"}
    assert len(loops) == 2 and set(flags) == {"rounds", "lm"} and flags.count("lm") >= 2


def test_the_configurations_that_step_eagerly_on_the_card(golden):
    _, cfg, _ = golden
    assert fe.graphable(cfg.frontend)
    for setting in ({"ego": "2d2d"}, {"redetect_min_free_fraction": 0.05}):
        assert not fe.graphable(_variant(cfg, **setting).frontend), setting


@pytest.mark.parametrize("module,name", [(refine, "round_iteration"), (homography, "normal_eigenvectors"),
                                         (fe, "_seg_pre")])
def test_a_replaced_module_function_keys_a_new_capture(frame_one, fresh_cache, monkeypatch, module, name):
    """A capture bakes in the functions its stretches call, so one replaced
    after a capture (as `bench_torch/controls.py` replaces module
    functions) keys a new capture, which runs the replacement; putting the
    original back finds the first capture."""
    c, inputs = frame_one
    first = fe._captured_step(inputs, c)
    real, calls = getattr(module, name), []
    monkeypatch.setattr(module, name, lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    patched = fe._captured_step(inputs, c)
    assert patched is not first and len(fe._FRAME_GRAPHS) == 2
    calls.clear()
    patched.step(inputs)
    assert calls
    monkeypatch.setattr(module, name, real)
    assert fe._captured_step(inputs, c) is first
