"""The split LM iteration of the direct-Schur window solve
(`backend/schur.py:_WindowLM`: the head and the iteration with and
without the normal-system rebuild, which read and write fixed state
tensors in place and which the card captures as CUDA graphs, driven by
the host loop `_lm_schedule`), run eagerly on the CPU against the eager
loop (`_lm_loop`, what `lm_optimize_schur` runs on the CPU) on simulator
windows: bit for bit, since both issue the same operators in the same
order.  One `_WindowLM` solves two windows of a 16-frame scenario in
turn, as a captured one serves every window of its shape.  The capture
cache is driven with the capture replaced by eager replays.
"""

import pytest
import torch

from dynosam_tpu_torch.backend import formulation as fm
from dynosam_tpu_torch.backend import map as bmap
from dynosam_tpu_torch.backend import schur
from dynosam_tpu_torch.backend.solver import LMConfig
from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig
from dynosam_tpu_torch.utils.config import BackendConfig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenario_map():
    scfg = ScenarioConfig(n_frames=16)
    m = bmap.MeasurementMap.create(16, scfg.ns, scfg.nd, scfg.no)
    for k, p in enumerate(Scenario(scfg).frontend_outputs()):
        bmap.update_map(m, p, k)
    return m


def _window(m, start, updater):
    cfg = BackendConfig(backend_updater_enum=updater)
    w = bmap.slice_window(m, start, 10)
    masks = fm.build_masks(w, cfg)
    v0 = fm.init_values(w, masks, cfg) if updater == 0 else fm.init_values_world_pose(w, masks, cfg)
    return cfg, w, masks, v0


def _assert_same(got, ref):
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(leaves(got.values), leaves(ref.values)))
    for f in ("error", "initial_error", "lam"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.iterations, got.converged) == (ref.iterations, ref.converged)


@pytest.mark.parametrize("updater,prior", [(0, False), (1, True)], ids=["world_motion", "world_pose_prior"])
def test_split_iteration_equals_the_eager_loop_bit_for_bit(scenario_map, updater, prior):
    """30 LM iterations allowed, so each solve both accepts and rejects
    steps; WorldPose with a full `anchor_prior_L` (the fixed-lag prior's
    form).  The CPU solve captures no graph."""
    L = torch.linalg.cholesky(torch.eye(6, dtype=torch.float64) * 1e8 + 1e7).float() if prior else None
    lm = LMConfig(max_iterations=30)
    counts = schur.graph_counts()
    split = None
    for start in (0, 6):
        cfg, w, masks, v0 = _window(scenario_map, start, updater)
        ref = schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0], formulation=updater, anchor_prior_L=L)
        if split is None:
            split = schur._WindowLM(v0, w, masks, cfg, lm, w.X_init[0], updater, L)
            real = split.iteration
            rebuilds = []
            split.iteration = lambda rebuild: (rebuilds.append(rebuild), real(rebuild))[1]
        rebuilds.clear()
        _assert_same(split.solve(v0, w, masks, w.X_init[0], L), ref)
        assert rebuilds[0] and True in rebuilds[1:] and False in rebuilds, rebuilds
    assert schur.graph_counts() == counts


def test_split_iteration_rejects_failed_choleskys_as_the_eager_loop(scenario_map, monkeypatch):
    """A normal system whose reduced Cholesky fails (Hcc negated) gives a
    NaN step on every iteration: both loops reject each one, raise lambda
    to its cap and stop with the values and error they started from."""
    real_build = schur.build_normal_system
    monkeypatch.setattr(schur, "build_normal_system",
                        lambda *a, **k: (lambda s: s._replace(Hcc=-s.Hcc))(real_build(*a, **k)))
    cfg, w, masks, v0 = _window(scenario_map, 0, 0)
    lm = LMConfig(max_iterations=30)
    ref = schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0])
    got = schur._WindowLM(v0, w, masks, cfg, lm, w.X_init[0]).solve(v0, w, masks, w.X_init[0])
    _assert_same(got, ref)
    assert got.converged and got.iterations == 13          # float32 lambda x 10 reaches the 1e7 cap on the 13th
    assert torch.equal(got.error, got.initial_error) and torch.equal(got.values["X"].t, v0["X"].t)


def test_captured_window_lms_are_reused_by_shape_and_settings(scenario_map, monkeypatch):
    """The capture cache with the CUDA capture replaced by replays that run
    the captured functions eagerly: windows of one shape and settings share
    one capture and solve as `lm_optimize_schur` does, bit for bit, with one
    replay for the head and one per LM iteration; another LM setting or
    formulation captures anew, and the cache keeps the most recent
    `_WINDOW_LMS_MAX`."""
    class Replay:
        def __init__(self, fn):
            self.replay = fn

    def fake_capture(lm):
        lm.graphs = {k: Replay(fn) for k, fn in lm._variants().items()}

    monkeypatch.setattr(schur._WindowLM, "capture", fake_capture)
    monkeypatch.setattr(schur, "_WINDOW_LMS", type(schur._WINDOW_LMS)())
    lm = LMConfig(max_iterations=3)
    counts = schur.graph_counts()
    first = None
    for start in (0, 6):
        cfg, w, masks, v0 = _window(scenario_map, start, 0)
        cached = schur._captured_window_lm(v0, w, masks, cfg, lm, w.X_init[0], 0, None)
        first = first or cached
        assert cached is first
        got = cached.solve(v0, w, masks, w.X_init[0])
        _assert_same(got, schur.lm_optimize_schur(v0, w, masks, cfg, lm, w.X_init[0]))
        now = schur.graph_counts()
        assert now["captures"] == counts["captures"] + 1
        assert now["replays"] - counts["replays"] == 1 + got.iterations
        counts["replays"] = now["replays"]
    others = [(LMConfig(max_iterations=n), 0) for n in (4, 5, 6)] + [(lm, 1)]
    for lm_other, updater in others:
        cfg, w, masks, v0 = _window(scenario_map, 0, updater)
        assert schur._captured_window_lm(v0, w, masks, cfg, lm_other, w.X_init[0], updater, None) is not first
    assert schur.graph_counts()["captures"] == counts["captures"] + 1 + len(others)
    assert len(schur._WINDOW_LMS) == schur._WINDOW_LMS_MAX and first not in schur._WINDOW_LMS.values()


@pytest.mark.parametrize("name", ["retract_tree", "schur_step", "total_error", "sqrt_weights"])
def test_a_replaced_module_function_captures_anew(scenario_map, monkeypatch, name):
    """A capture bakes in the module functions its iteration calls, so one
    replaced after a capture (as the benchmark's `bf16_state` control
    replaces `retract_tree`) keys a new capture, which runs the
    replacement; putting the original back finds the first capture."""
    class Replay:
        def __init__(self, fn):
            self.replay = fn

    def fake_capture(lm):
        lm.graphs = {k: Replay(fn) for k, fn in lm._variants().items()}

    monkeypatch.setattr(schur._WindowLM, "capture", fake_capture)
    monkeypatch.setattr(schur, "_WINDOW_LMS", type(schur._WINDOW_LMS)())
    cfg, w, masks, v0 = _window(scenario_map, 0, 0)
    lm = LMConfig(max_iterations=3)
    first = schur._captured_window_lm(v0, w, masks, cfg, lm, w.X_init[0], 0, None)
    real, calls = getattr(schur, name), []
    monkeypatch.setattr(schur, name, lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    patched = schur._captured_window_lm(v0, w, masks, cfg, lm, w.X_init[0], 0, None)
    assert patched is not first and len(schur._WINDOW_LMS) == 2
    calls.clear()
    patched.solve(v0, w, masks, w.X_init[0])
    assert calls
    monkeypatch.setattr(schur, name, real)
    assert schur._captured_window_lm(v0, w, masks, cfg, lm, w.X_init[0], 0, None) is first
