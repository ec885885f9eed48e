"""The port's batched window solves against the JAX package:
`backend/batch_windows.py` (`window_starts`, `solve_all_windows`) and the
grouped dispatch of the offline runner (`backend.solve_windows`, the port
of `throughput._solve_windows_batched`, `opt_windows_per_dispatch`).

Tolerances: window starts, estimate-store masks and stitched validity
equal; final errors and camera translations within twice the float32
floor measured here (`test_torch_world_pose_solve._floor_and_diff`: JAX's
and the port's spreads when the static and dynamic measurements move by
one part in 1e7); a grouped dispatch of one window equals the sequential
solve exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu import throughput as jtp
from dynosam_tpu.backend import batch_windows as jbw
from dynosam_tpu.backend.solver import LMConfig as JLMConfig
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu_torch import convert
from dynosam_tpu_torch import throughput as ttp
from dynosam_tpu_torch.backend import backend as tbe
from dynosam_tpu_torch.backend import batch_windows as tbw
from dynosam_tpu_torch.backend.solver import LMConfig
from dynosam_tpu_torch.utils import config as tcfg

from test_torch_schur import port_map, port_packets, to_jax
from test_torch_world_pose_solve import _jiggle

torch.set_num_threads(2)

DRAWS = 2


@pytest.mark.parametrize("n,size,overlap", [(16, 10, 4), (22, 10, 4), (8, 10, 4), (10, 10, 4), (23, 6, 2),
                                            (5, 5, 0), (31, 7, 3)])
def test_window_starts_match_jax(n, size, overlap):
    starts = tbw.window_starts(n, size, overlap)
    assert starts == jbw.window_starts(n, size, overlap)
    assert starts[0] == 0 and starts[-1] + size >= n


def _scenario():
    """(config, the JAX map) of the 16-frame scenario: the JAX simulator's
    packets in the map, built once per process through the port
    (`test_torch_schur.port_map`, JAX's bits)."""
    scfg = ScenarioConfig(n_frames=16)
    return scfg, to_jax(port_map(scfg))


def _port_map(jm):
    return convert.measurement_map_from_numpy(jax.tree.map(np.asarray, jm), device="cpu")


def _floors(jax_solve, port_solve, jm):
    """JAX and port spreads over `DRAWS` perturbed maps and the port-vs-JAX
    difference, each (relative error, camera translations)."""
    rng = np.random.default_rng(0)
    jruns, truns = [], []
    for draw in range(DRAWS + 1):
        m = jm
        if draw:
            m = _jiggle(jm, rng)                 # the map's measurements, as a whole-map window's
        jruns.append(jax_solve(m))
        truns.append(port_solve(_port_map(m)))

    def spread(runs):
        e0, t0 = runs[0]
        return (max(float(np.max(np.abs(e / e0 - 1))) for e, _ in runs[1:]),
                max(float(np.abs(t - t0).max()) for _, t in runs[1:]))

    (je0, jt0), (te0, tt0) = jruns[0], truns[0]
    return spread(jruns), spread(truns), (float(np.max(np.abs(te0 / je0 - 1))), float(np.abs(tt0 - jt0).max()))


def test_solve_all_windows_matches_jax():
    """Every window of 16 frames (windows 10/4 at 0 and 6, uncompacted, 7
    LM iterations) in one batched solve, stitched."""
    scfg, jm = _scenario()
    jc = jcfg.BackendConfig(lm_max_iterations=7)
    tc = tcfg.BackendConfig(lm_max_iterations=7)
    out = {}

    def jax_solve(m):
        est, errs, errs0, starts = jbw.solve_all_windows(m, 16, jc, JLMConfig(max_iterations=7))
        out["jax"] = (est, errs0, starts)
        return errs, np.asarray(est["X"].t)

    def port_solve(m):
        est, errs, errs0, starts = tbw.solve_all_windows(m, 16, tc, LMConfig(max_iterations=7))
        out.setdefault("port", (est, errs0, starts))
        return errs, est["X"].t.numpy()

    (je, jt), (te, tt), (de, dt) = _floors(jax_solve, port_solve, jm)
    est, errs0, starts = out["port"]
    jest, jerrs0, jstarts = out["jax"]
    assert starts == jstarts == [0, 6]
    assert np.array_equal(est["X_valid"].numpy(), np.asarray(jest["X_valid"])) and est["X_valid"].all()
    assert np.array_equal(est["H_valid"].numpy(), np.asarray(jest["H_valid"]))
    np.testing.assert_allclose(errs0, np.asarray(jerrs0), rtol=1e-5)
    assert de <= 2 * (je + te), (de, je, te)
    assert dt <= 2 * (jt + tt), (dt, jt, tt)


@pytest.mark.parametrize("updater", [0, 1])
def test_grouped_dispatch_matches_jax(updater):
    """Two windows (0 and 6) of 16 frames in one dispatch from an empty
    store, compacted (caps 128/96/3), 7 LM iterations: the port's
    `solve_windows` against JAX's `_solve_windows_batched`, store masks
    equal, errors and camera translations within the measured floor."""
    scfg, jm = _scenario()
    kw = dict(window_max_static=128, window_max_dynamic=96, window_max_objects=3, lm_max_iterations=7,
              opt_windows_per_dispatch=2, backend_updater_enum=updater)
    jc = jcfg.DynoConfig(backend=jcfg.BackendConfig(**kw))
    tc = tcfg.BackendConfig(**kw)
    solve = jax.jit(jtp._solve_windows_batched,
                    static_argnames=("wpd", "stride", "window", "cfg", "lm_cfg", "pose_key", "updater"))
    out = {}

    def jax_solve(m):
        est, last = solve(jtp.EstStore.create(16, scfg.ns, scfg.nd, scfg.no), m, jnp.int32(0), wpd=2, stride=6,
                          window=10, cfg=jc, lm_cfg=jtp._lm_cfg(jc.backend), pose_key="HL"[updater], updater=updater)
        out.setdefault("jax", (jax.tree.map(np.asarray, est), int(last.iterations)))
        return float(last.error), np.asarray(est.X.t)

    def port_solve(m):
        est = tbe.EstimateStore.create(16, scfg.ns, scfg.nd, scfg.no, device="cpu")
        res = tbe.solve_windows(est, m, [0, 6], 10, tc, tbe.lm_config(tc))
        out.setdefault("port", (convert.frontend_output_to_numpy(est), res))
        return float(res[-1][0].error), est.X.t.numpy()

    (je, jt), (te, tt), (de, dt) = _floors(jax_solve, port_solve, jm)
    (a, jit), (t, res) = out["jax"], out["port"]
    for f in ("static_valid", "dyn_valid", "X_valid", "motion_valid"):
        assert np.array_equal(getattr(a, f), getattr(t, f)), f
    assert abs(res[-1][0].iterations - jit) <= 1
    assert all(float(r.error) < float(r.initial_error) for r, _ in res)
    assert de <= 2 * (je + te), (de, je, te)
    assert dt <= 2 * (jt + tt), (dt, jt, tt)


def _runner_cfg(scfg, **kw):
    return tcfg.DynoConfig(
        backend=tcfg.BackendConfig(window_max_static=128, window_max_dynamic=96, window_max_objects=3,
                                   lm_max_iterations=7, **kw),
        capacity=tcfg.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd, max_objects=scfg.no,
                                     max_frames=scfg.n_frames))


def test_runner_groups_windows_and_falls_back():
    """With wpd 2 the runner solves windows in pairs once the pair's last
    window completes (28 frames: windows 0, 6 | 12, 18); a wpd that does
    not divide the 3 segments of 22 frames falls back to 1 (each window as
    it completes, equal to the runner without the option)."""
    scfg = ScenarioConfig(n_frames=28)
    tp = port_packets(scfg)
    runner = ttp.make_offline_runner(None, _runner_cfg(scfg, opt_windows_per_dispatch=2), 28, device="cpu")
    assert runner.wpd == 2
    due = []
    for k, p in enumerate(tp):
        runner.add_packet(p)
        d = runner.windows_due()
        if d:
            due.append((k, d))
            runner.solve_group(d)
    assert due == [(15, [0, 6]), (27, [12, 18])]
    assert [w.start for w in runner.windows] == [0, 6, 12, 18]
    assert runner.windows[0].events is runner.windows[1].events is None
    assert runner.est.X_valid[:28].all()

    scfg22 = dataclasses.replace(scfg, n_frames=22)
    r2 = ttp.make_offline_runner(None, _runner_cfg(scfg22, opt_windows_per_dispatch=2), 22, device="cpu")
    r1 = ttp.make_offline_runner(None, _runner_cfg(scfg22), 22, device="cpu")
    assert r2.wpd == 1
    for p in tp[:22]:
        for r in (r1, r2):
            r.add_packet(p)
            for s in r.windows_due():
                r.solve(s)
    assert [w.start for w in r2.windows] == [0, 6, 12]
    assert torch.equal(r1.est.X.t, r2.est.X.t)
