"""The port's distributed LM-PCG (`dynosam_tpu_torch/parallel/distributed_ba.py`:
factors partitioned by frame block, values replicated, one all_reduce per
product, gradient and cost; damped and preconditioned by Hutchinson's
diagonal, as JAX's `distributed_optimize` is) against the port's
single-process `solver.lm_optimize(gn_diag_fn=None)` and JAX's
`distributed_optimize`.

Gloo ranks on the CPU, one process each (`testing.gloo.run_ranks`).

Tolerances:

* float64, two ranks (and 2x2 with a tracks axis): the rank-summed cost,
  gradient, J^T W J v and Hutchinson diagonal (8 probes from a generator
  seeded 0) at the initial point equal the single-process ones to 1e-12
  relative: the decomposition is exact up to summation order;
* float64, the whole LM-PCG (6 LM iterations of 60 CG, the settings of
  `tests/test_distributed.py:36-57`), every rank and the single process
  drawing the same probes: the same LM iteration count, both errors below
  0.005 of the initial error, camera translations within 2e-3 m and
  object motions or poses within 5e-3 m of the single-process solve.  Not
  1e-6: the PCG stops unconverged (Jacobi, ~1e10 conditioning from the
  1e-5 ternary and 1e-4 anchor sigmas), and it amplifies the 1e-16
  summation-order differences the first item allows over 6 LM iterations;
* float32 against JAX's `distributed_optimize(make_mesh(2, tracks=1))` at
  the same settings, both ranks given the probes JAX draws
  (`fold_in(PRNGKey(0), it)`): both errors below 0.005 of their initial
  error, X translations within 2e-2 m and H translations within 5e-2 m,
  the bands of `:36-57`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dynosam_tpu_torch.testing.gloo import run_ranks

ROOT = Path(__file__).resolve().parent.parent
PYPATH = [str(ROOT), str(ROOT / "tests")]
TIMEOUT = 240


def port_problem(dtype):
    """The port's map of `tests/test_distributed.py:17-25`'s scenario."""
    from dynosam_tpu_torch.backend.map import MeasurementMap, update_map
    from dynosam_tpu_torch.core.lie import SE3
    from dynosam_tpu_torch.testing.simulator import Scenario, ScenarioConfig

    sc = Scenario(ScenarioConfig(n_frames=8, n_static=40, n_objects=2, pts_per_object=12, ns=64, nd=32, no=4))
    m = MeasurementMap.create(8, 64, 32, 4)
    for k, pkt in enumerate(sc.frontend_outputs()):
        m = update_map(m, pkt, k)

    def cast(x):
        if isinstance(x, SE3):
            return SE3(x.R.to(dtype), x.t.to(dtype))
        return x.to(dtype) if x.is_floating_point() else x

    return MeasurementMap(*(cast(x) for x in m))


def single(m, updater):
    """The single-process window pieces, as `backend.optimize_window`
    wires them into `lm_optimize`."""
    from dynosam_tpu_torch.backend import formulation as fm
    from dynosam_tpu_torch.backend.map import slice_window
    from dynosam_tpu_torch.backend.schur import world_motion_normal_product, world_pose_normal_product
    from dynosam_tpu_torch.utils.config import BackendConfig

    cfg = BackendConfig(backend_updater_enum=updater)
    w = slice_window(m, 0, 8)
    masks = fm.build_masks(w, cfg)
    if updater == 0:
        vals = fm.init_values(w, masks, cfg)
        fam, res, prod = fm.world_motion_families, fm.world_motion_residuals, world_motion_normal_product
    else:
        vals = fm.init_values_world_pose(w, masks, cfg)
        fam, res, prod = fm.world_pose_families, fm.world_pose_residuals, world_pose_normal_product
    a = w.X_init[0]
    return dict(values=vals, specs=fam(cfg).robust, residual_fn=lambda v: res(v, w, masks, cfg, a),
                normal_fn=lambda v, sw, r: prod(v, sw, r, w, masks, cfg, a))


def seeded_probes(template: dict) -> list:
    """The Hutchinson probes `lm_optimize` draws at its first LM iteration
    when given none: 8 from a generator seeded 0."""
    from dynosam_tpu_torch.backend.solver import HUTCHINSON_PROBES, rademacher_probes

    return rademacher_probes(template, HUTCHINSON_PROBES, torch.Generator().manual_seed(0))


def dba_rank(rank, world, tracks, updater, x64, probes_file=None):
    """One rank: its summed pieces at the initial point (with a fixed
    probe direction), then the whole distributed solve, with the probes
    saved in `probes_file` (a list per LM iteration) when given."""
    from dynosam_tpu_torch.backend.solver import LMConfig, hutchinson_diag, sqrt_weights, zero_delta
    from dynosam_tpu_torch.parallel.distributed_ba import distributed_optimize, rank_problem
    from dynosam_tpu_torch.parallel.mesh import make_mesh
    from dynosam_tpu_torch.utils.config import BackendConfig

    dtype = torch.float64 if x64 else torch.float32
    m = port_problem(dtype)
    cfg = BackendConfig(backend_updater_enum=updater)
    mesh = make_mesh(tracks=tracks)
    p = rank_problem(m, 8, cfg, mesh, updater)
    res = p.residual_fn(p.values)
    sw = sqrt_weights(res, p.specs)
    mv, g = p.normal_fn(p.values, sw, res)
    gen = torch.Generator().manual_seed(1)
    d = {k: torch.randn(v.shape, generator=gen, dtype=dtype) for k, v in g.items()}
    pieces = {"error": p.error_fn(res), "g": g, "mv": mv(d),
              "hdiag": hutchinson_diag(mv, seeded_probes(zero_delta(p.values)))}
    lm = LMConfig(max_iterations=6, cg_max_iterations=60)
    given = torch.load(probes_file) if probes_file else None
    r = distributed_optimize(m, 8, cfg, mesh=mesh, updater=updater, lm_cfg=lm,
                             probes=None if given is None else given.__getitem__)
    return {"pieces": pieces, "d": d, "values": r.values, "error": float(r.error),
            "initial_error": float(r.initial_error), "iterations": r.iterations}


@pytest.fixture(scope="module")
def single_refs():
    """For each updater, the single-process problem and its 6-iteration
    LM-PCG, shared by both mesh shapes."""
    from dynosam_tpu_torch.backend.solver import LMConfig, lm_optimize

    out = {}
    for updater in (0, 1):
        s = single(port_problem(torch.float64), updater)
        out[updater] = s, lm_optimize(s["residual_fn"], s["specs"], s["values"],
                                      LMConfig(max_iterations=6, cg_max_iterations=60), normal_fn=s["normal_fn"],
                                      gn_diag_fn=None)
    return out


@pytest.mark.parametrize("updater", [0, 1])
@pytest.mark.parametrize("world,tracks", [(2, 1), (4, 2)], ids=["2x1", "2x2"])
def test_distributed_lm_pcg_matches_single_process_f64(single_refs, world, tracks, updater):
    from dynosam_tpu_torch.backend.solver import hutchinson_diag, sqrt_weights, total_error, zero_delta

    out = run_ranks("test_torch_distributed_ba:dba_rank", world, dict(tracks=tracks, updater=updater, x64=True),
                    TIMEOUT, PYPATH)
    s, ref = single_refs[updater]
    res = s["residual_fn"](s["values"])
    sw = sqrt_weights(res, s["specs"])
    mv, g = s["normal_fn"](s["values"], sw, res)
    want = {"g": g, "mv": mv(out[0]["d"]), "hdiag": hutchinson_diag(mv, seeded_probes(zero_delta(s["values"])))}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

    for o in out:
        got = o["pieces"]
        assert rel(got["error"], total_error(res, s["specs"])) < 1e-12
        for key in ("g", "mv", "hdiag"):
            assert want[key].keys() == got[key].keys()
            for k in want[key]:
                assert rel(got[key][k], want[key][k]) < 1e-12, (key, k)

    pk = "H" if updater == 0 else "L"
    for o in out:
        assert o["iterations"] == ref.iterations
        assert o["error"] < 0.005 * o["initial_error"] and float(ref.error) < 0.005 * float(ref.initial_error)
        assert float((o["values"]["X"].t - ref.values["X"].t).abs().max()) < 2e-3
        assert float((o["values"][pk].t - ref.values[pk].t).abs().max()) < 5e-3


def test_distributed_lm_pcg_matches_jax_f32(tmp_path):
    """Two float32 ranks against JAX's GSPMD-partitioned solve on
    `make_mesh(2, tracks=1)`, the settings of `tests/test_distributed.py:36-57`,
    both ranks given JAX's Hutchinson probes."""
    import jax

    from dynosam_tpu.backend.solver import LMConfig as JLMConfig
    from dynosam_tpu.parallel.distributed_ba import distributed_optimize as jdo
    from dynosam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from dynosam_tpu.testing.simulator import ScenarioConfig
    from dynosam_tpu.utils.config import BackendConfig as JBackendConfig
    from dynosam_tpu_torch.backend.solver import zero_delta

    from test_torch_schur import port_map, to_jax
    from test_torch_solver import jax_probes

    # the JAX simulator's map, built through the port (JAX's bits)
    m = to_jax(port_map(ScenarioConfig(n_frames=8, n_static=40, n_objects=2, pts_per_object=12, ns=64, nd=32,
                                       no=4)))
    lm = JLMConfig(max_iterations=6, cg_max_iterations=60)
    jres = jdo(jax.tree.map(np.asarray, m), 8, JBackendConfig(), mesh=jmake_mesh(2, tracks=1), lm_cfg=lm)
    template = {k: jax.numpy.zeros(v.shape, jax.numpy.float32)
                for k, v in zero_delta(single(port_problem(torch.float32), 0)["values"]).items()}
    probes_file = str(tmp_path / "probes.pt")
    torch.save([jax_probes(template, it) for it in range(lm.max_iterations)], probes_file)
    o = run_ranks("test_torch_distributed_ba:dba_rank", 2,
                  dict(tracks=1, updater=0, x64=False, probes_file=probes_file), TIMEOUT, PYPATH)[0]
    assert np.isfinite(o["error"]) and np.isfinite(float(jres.error))
    assert o["error"] < 0.005 * o["initial_error"]
    assert float(jres.error) < 0.005 * float(jres.initial_error)
    np.testing.assert_allclose(o["values"]["X"].t.numpy(), np.asarray(jres.values["X"].t), atol=2e-2)
    np.testing.assert_allclose(o["values"]["H"].t.numpy(), np.asarray(jres.values["H"].t), atol=5e-2)
