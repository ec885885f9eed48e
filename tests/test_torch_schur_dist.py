"""The port's distributed window solve (`dynosam_tpu_torch/parallel/schur_dist.py`:
per-rank residual, error, build and step through
`backend/schur.py:lm_optimize_schur(overrides=...)`, explicit collectives)
against the port's single-process solve and against JAX's
`distributed_schur_optimize`, both updaters.

Gloo ranks on the CPU, one process each (`testing.gloo.run_ranks`).

Tolerances:

* float64 against the single-process `lm_optimize_schur` on the
  `parallel/mp_worker.py` scenario (window 8, 4 LM iterations), meshes
  (F, T) = (2, 1) and (2, 2): max |dX_t| and the relative error change
  below 1e-6 (updater 0) and 2e-5 (updater 1): `mp_worker.py:112-124`'s
  bar; the iteration counts equal;
* float32 against JAX's `distributed_schur_optimize` on
  `make_mesh(2, tracks=1)` (`tests/test_distributed.py:17-25`'s problem):
  the final error within rtol 3e-2 and camera translations within 2e-3 m,
  the float32 floor at which `tests/test_torch_schur.py` holds the
  single-device solve to JAX's, inside `tests/test_distributed.py:115-122`'s
  bands; both errors below 0.005 of their initial error for updater 0 and
  below it for updater 1 (`:134-136`);
* collectives per LM iteration, counted by wrapping the
  `torch.distributed` calls inside the ranks: 7 with a split frame axis
  (`schur_dist.py`'s module docstring lists them; the one-block count, 2,
  is checked on the card by `tests/test_torch_cuda.py`).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dynosam_tpu_torch.testing.gloo import run_ranks

ROOT = Path(__file__).resolve().parent.parent
PYPATH = [str(ROOT), str(ROOT / "tests")]
TIMEOUT = 240


def port_problem(dtype, window=8, n_static=48, pts=24, ns=64, nd=64):
    """The port's map of a simulator scenario (the JAX scenario's port)."""
    from dynosam_tpu_torch.backend.map import MeasurementMap, update_map
    from dynosam_tpu_torch.core.lie import SE3
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig

    sc = Scenario(ScenarioConfig(n_frames=window, n_static=n_static, n_objects=2, pts_per_object=pts,
                                 ns=ns, nd=nd, no=4))
    m = MeasurementMap.create(window, ns, nd, 4)
    for k, pkt in enumerate(sc.frontend_outputs()):
        m = update_map(m, pkt, k)

    def cast(x):
        if isinstance(x, SE3):
            return SE3(x.R.to(dtype), x.t.to(dtype))
        return x.to(dtype) if x.is_floating_point() else x

    return MeasurementMap(*(cast(x) for x in m))


def single_solve(m, window, updater, lm):
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend.map import slice_window
    from dynosam_tpu_torch.backend.schur import lm_optimize_schur
    from dynosam_tpu_torch.utils.config import BackendConfig

    cfg = BackendConfig(backend_updater_enum=updater)
    w = slice_window(m, 0, window)
    masks = fm.build_masks(w, cfg)
    vals = fm.init_values(w, masks, cfg) if updater == 0 else fm.init_values_world_pose(w, masks, cfg)
    return lm_optimize_schur(vals, w, masks, cfg, lm, w.X_init[0], formulation=updater)


def solve_rank(rank, world, tracks, updater, x64, problem):
    """One rank: the distributed solve with every `torch.distributed` call
    counted, its values gathered whole, and the ValueErrors of bad splits."""
    import torch.distributed as dist

    from dynosam_tpu_torch.backend.solver import LMConfig
    from dynosam_tpu_torch.parallel.mesh import make_mesh, mesh_coords
    from dynosam_tpu_torch.parallel.schur_dist import distributed_schur_optimize, gather_values
    from dynosam_tpu_torch.utils.config import BackendConfig

    dtype = torch.float64 if x64 else torch.float32
    m = port_problem(dtype) if problem == "worker" else port_problem(dtype, n_static=40, pts=12, nd=32)
    cfg = BackendConfig(backend_updater_enum=updater)
    lm = LMConfig(max_iterations=4 if problem == "worker" else (8 if updater == 0 else 6))
    mesh = make_mesh(tracks=tracks)
    calls = {"n": 0}
    names = [n for n in ("all_reduce", "batch_isend_irecv", "all_gather_single", "all_gather_into_tensor")
             if hasattr(dist, n)]
    saved = {n: getattr(dist, n) for n in names}

    def counted(fn):
        def wrap(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)
        return wrap

    for n in names:
        setattr(dist, n, counted(saved[n]))
    try:
        res = distributed_schur_optimize(m, 8, cfg, mesh=mesh, updater=updater, lm_cfg=lm)
    finally:
        for n in names:
            setattr(dist, n, saved[n])
    out = {"coords": mesh_coords(mesh), "calls": calls["n"], "iterations": res.iterations,
           "error": float(res.error), "initial_error": float(res.initial_error),
           "values": gather_values(res.values, mesh)}
    errors = []
    for bad in (lambda: distributed_schur_optimize(m, 7, cfg, mesh=mesh, lm_cfg=lm),
                lambda: distributed_schur_optimize(m, 2 if mesh.size(0) == 2 else 3, cfg, mesh=mesh, lm_cfg=lm)):
        try:
            bad()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    if tracks == 2:
        try:
            distributed_schur_optimize(port_problem(dtype, nd=63), 8, cfg, mesh=mesh, lm_cfg=lm)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["value_errors"] = errors
    return out


@pytest.fixture(scope="module")
def worker_problem():
    return port_problem(torch.float64)


@pytest.fixture(scope="module")
def single_refs(worker_problem):
    """The single-process solve of the worker problem for each updater,
    shared by both mesh shapes."""
    from dynosam_tpu_torch.backend.solver import LMConfig

    return {u: single_solve(worker_problem, 8, u, LMConfig(max_iterations=4)) for u in (0, 1)}


@pytest.mark.parametrize("updater", [0, 1])
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_distributed_schur_matches_single_process_f64(single_refs, mesh_shape, updater):
    """Float64: the distributed solve equals the single-process solve to
    mp_worker's bar, with 7 collectives per LM iteration, and refuses a
    window or a track pool that does not split."""
    F, T = mesh_shape
    out = run_ranks("test_torch_schur_dist:solve_rank", F * T,
                    dict(tracks=T, updater=updater, x64=True, problem="worker"), TIMEOUT, PYPATH)
    ref = single_refs[updater]
    tol = 1e-6 if updater == 0 else 2e-5
    pk = "H" if updater == 0 else "L"
    for o in out:
        v = o["values"]
        assert o["iterations"] == ref.iterations
        assert float((v["X"].t - ref.values["X"].t).abs().max()) < tol
        assert abs(o["error"] - float(ref.error)) / float(ref.error) < tol
        assert float((v[pk].t - ref.values[pk].t).abs().max()) < 10 * tol
        assert float((v["dp"] - ref.values["dp"]).abs().max()) < 100 * tol
        assert float((v["sp"] - ref.values["sp"]).abs().max()) < 10 * tol
        # prologue: one all_gather of the dynamic ids; the initial residual
        # and error: one ghost exchange, one all_reduce; then 7 per iteration
        assert o["calls"] == 1 + 2 + 7 * o["iterations"], o["calls"]
        msgs = o["value_errors"]
        assert all(m is not None and "must split" in m for m in msgs[:2]), msgs
        if T == 2:
            assert msgs[2] is not None and "does not split" in msgs[2], msgs


@pytest.fixture(scope="module")
def jax_problem():
    """The JAX simulator's map of the scenario as numpy leaves, built
    through the port (`test_torch_schur.port_map`, JAX's bits)."""
    import jax

    from dynosam_tpu.testing.simulator import ScenarioConfig

    from test_torch_schur import port_map, to_jax

    scfg = ScenarioConfig(n_frames=8, n_static=40, n_objects=2, pts_per_object=12, ns=64, nd=32, no=4)
    return jax.tree.map(np.asarray, to_jax(port_map(scfg)))


@pytest.mark.parametrize("updater", [0, 1])
def test_distributed_schur_matches_jax_f32(jax_problem, updater):
    """Float32 on two ranks against JAX's explicit path on
    `make_mesh(2, tracks=1)` over the same scenario."""
    from dynosam_tpu.backend.solver import LMConfig as JLMConfig
    from dynosam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from dynosam_tpu.parallel.schur_dist import distributed_schur_optimize as jdso
    from dynosam_tpu.utils.config import BackendConfig as JBackendConfig

    n_it = 8 if updater == 0 else 6
    jres = jdso(jax_problem, 8, JBackendConfig(backend_updater_enum=updater), mesh=jmake_mesh(2, tracks=1),
                updater=updater, lm_cfg=JLMConfig(max_iterations=n_it))
    out = run_ranks("test_torch_schur_dist:solve_rank", 2,
                    dict(tracks=1, updater=updater, x64=False, problem="jax"), TIMEOUT, PYPATH)
    o = out[0]
    assert abs(o["iterations"] - int(jres.iterations)) <= 1
    np.testing.assert_allclose(o["error"], float(jres.error), rtol=3e-2)
    np.testing.assert_allclose(o["values"]["X"].t.numpy(), np.asarray(jres.values["X"].t), atol=2e-3)
    if updater == 0:
        assert o["error"] < 0.005 * o["initial_error"]
        assert float(jres.error) < 0.005 * float(jres.initial_error)
    else:
        assert o["error"] < o["initial_error"]


def test_lm_optimize_schur_refuses_a_chain_solver(worker_problem):
    """`chain_solver` needs the subtractive elimination the port leaves
    out; the stable step raises instead of ignoring it."""
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend.map import slice_window
    from dynosam_tpu_torch.backend.schur import lm_optimize_schur
    from dynosam_tpu_torch.backend.solver import LMConfig
    from dynosam_tpu_torch.utils.config import BackendConfig

    cfg = BackendConfig()
    w = slice_window(worker_problem, 0, 8)
    masks = fm.build_masks(w, cfg)
    with pytest.raises(NotImplementedError, match="DYNO_SCHUR_STABLE=0"):
        lm_optimize_schur(fm.init_values(w, masks, cfg), w, masks, cfg, LMConfig(), w.X_init[0],
                          chain_solver=lambda *a: None)
