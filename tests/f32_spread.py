"""How far float32 rounding alone moves a backend window solve, in the JAX
package and in the port: the measurements behind the LM and segment-loop
tolerances of `tests/test_torch_schur.py` and `tests/test_torch_throughput.py`.

    JAX_PLATFORMS=cpu python tests/f32_spread.py [section ...]

(sections: lm, loop, full_batch, online, one_step; all by default)

Prints, on the CPU:

1. the JAX 7-iteration LM on the window-10 scenario of
   `test_torch_schur.py`, rerun with its static measurements scaled by
   (1 + 1e-7 N(0, 1)) (8 draws): the spread of the final error and of the
   camera translations;
2. the port's same LM at 1, 2, 4 and 8 CPU threads (a different order of
   float32 sums each): the same spreads against 1 thread;
3. the JAX segment loop of `test_torch_throughput.py` (16 frames, windows
   at 0 and 6) under the same perturbation: camera translations after
   each window;
4. the port's segment loop at 1, 2, 4 and 8 CPU threads: camera
   translations after each window against 1 thread; then the port's loop
   under the perturbation of item 3 (same draws, 2 threads): camera
   translations after each window, the like-for-like twin of item 3;
5. the full-batch LM-PCG (`use_full_batch_opt`, `use_schur=False`) of
   `test_torch_solver.py` on the 8-frame scenario, 30 LM iterations: the
   JAX solve under the perturbation of item 1, and the port's under the
   same draws (2 threads) and at 1, 2, 4 and 8 threads: the spread of the
   final error and of the camera translations;
6. the online backend runs of `test_torch_backend_online.py`
   (`run_from_packets`: "sliding", windows 5/2 over 10 frames, and
   "full_batch", 20 frames through LM-PCG), JAX and port under the
   perturbation of item 1 (the port at 2 threads): camera translations;
7. for scale, the port against (jitted) JAX on one linearisation, the one
   of `test_torch_schur.py`: the largest normal-system field difference
   and the Schur step differences at lambda 1e-4 and 1e-7, each relative
   to its max-abs.

It takes a few minutes; it is not collected as a test.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dynosam_tpu import throughput as jtp  # noqa: E402
from dynosam_tpu.backend import formulation as jfm  # noqa: E402
from dynosam_tpu.backend import map as jmap  # noqa: E402
from dynosam_tpu.backend import schur as jschur  # noqa: E402
from dynosam_tpu.backend.solver import LMConfig  # noqa: E402
from dynosam_tpu.testing.simulator import Scenario, ScenarioConfig  # noqa: E402
from dynosam_tpu.utils import config as jcfg  # noqa: E402
from dynosam_tpu_torch import convert  # noqa: E402
from dynosam_tpu_torch import throughput as ttp  # noqa: E402
from dynosam_tpu_torch.utils import config as tcfg  # noqa: E402

DRAWS = 8


def jiggle(xyz, rng):
    return xyz * (1 + 1e-7 * jnp.asarray(rng.standard_normal(xyz.shape), jnp.float32))


def lm_spread():
    packets = Scenario(ScenarioConfig(n_frames=10)).frontend_outputs()
    cfg = jcfg.BackendConfig()
    rng = np.random.default_rng(0)
    out = []
    for draw in range(DRAWS + 1):
        m = jmap.MeasurementMap.create(10, 160, 128, 4)
        for k, p in enumerate(packets):
            if draw:
                p = p._replace(static_obs=p.static_obs._replace(xyz=jiggle(p.static_obs.xyz, rng)))
            m = jmap.update_map(m, p, k)
        w = jmap.slice_window(m, 0, 10)
        masks = jfm.build_masks(w, cfg)
        res = jax.jit(lambda v: jschur.lm_optimize_schur(v, w, masks, cfg, LMConfig(max_iterations=7),
                                                         w.X_init[0]))(jfm.init_values(w, masks, cfg))
        out.append((float(res.error), np.asarray(res.values["X"].t)))
    errs = [abs(e / out[0][0] - 1) for e, _ in out[1:]]
    dts = [np.abs(t - out[0][1]).max() for _, t in out[1:]]
    print(f"1. JAX LM, 7 iterations: final error moves by up to {max(errs):.3g} (relative), "
          f"camera translations by up to {max(dts):.3g} m over {DRAWS} draws")

    from dynosam_tpu_torch.backend import formulation as tfm
    from dynosam_tpu_torch.backend import map as tmap
    from dynosam_tpu_torch.backend import schur as tschur
    from dynosam_tpu_torch.backend.solver import LMConfig as TLMConfig

    tm = tmap.MeasurementMap.create(10, 160, 128, 4, device="cpu")
    for k, p in enumerate(packets):
        tmap.update_map(tm, convert.frontend_output_from_numpy(jax.tree.map(np.asarray, p), device="cpu"), k)
    tc = tcfg.BackendConfig()
    tw = tmap.slice_window(tm, 0, 10)
    tmk = tfm.build_masks(tw, tc)
    port = {}
    for threads in (1, 2, 4, 8):
        torch.set_num_threads(threads)
        r = tschur.lm_optimize_schur(tfm.init_values(tw, tmk, tc), tw, tmk, tc, TLMConfig(max_iterations=7),
                                     tw.X_init[0])
        port[threads] = (float(r.error), r.values["X"].t.numpy())
    errs = [abs(port[t][0] / port[1][0] - 1) for t in (2, 4, 8)]
    dts = [np.abs(port[t][1] - port[1][1]).max() for t in (2, 4, 8)]
    print(f"2. port LM at 2, 4, 8 threads against 1: final error moves by up to {max(errs):.3g} (relative), "
          f"camera translations by up to {max(dts):.3g} m")


def loop_cfg(mod, scfg):
    return mod.DynoConfig(
        backend=mod.BackendConfig(window_max_static=128, window_max_dynamic=96, window_max_objects=3,
                                  lm_max_iterations=7),
        capacity=mod.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd,
                                    max_objects=scfg.no, max_frames=scfg.n_frames))


def loop_spread():
    scfg = ScenarioConfig(n_frames=16)
    packets = Scenario(scfg).frontend_outputs()
    jc, tc = loop_cfg(jcfg, scfg), loop_cfg(tcfg, scfg)
    solve = jax.jit(jtp._solve_window, static_argnames=("window", "cfg", "lm_cfg", "pose_key", "updater"))
    rng = np.random.default_rng(0)
    runs = []
    for draw in range(DRAWS + 1):
        m = jmap.MeasurementMap.create(16, scfg.ns, scfg.nd, scfg.no)
        est = jtp.EstStore.create(16, scfg.ns, scfg.nd, scfg.no)
        snaps = []
        for k, p in enumerate(packets):
            if draw:
                p = p._replace(static_obs=p.static_obs._replace(xyz=jiggle(p.static_obs.xyz, rng)))
            m = jmap.update_map(m, p, k)
            if k >= 9 and (k - 9) % 6 == 0:
                est, _ = solve(est, m, jnp.int32(k - 9), window=10, cfg=jc, lm_cfg=jtp._lm_cfg(jc.backend),
                               pose_key="H", updater=0)
                snaps.append(np.asarray(est.X.t))
        runs.append(snaps)
    worst = np.max([[np.abs(a - b).max() for a, b in zip(runs[0], r)] for r in runs[1:]], axis=0)
    print(f"3. JAX segment loop: camera translations move by up to {worst[0]:.3g} m after window 1, "
          f"{worst[1]:.3g} m after window 2 over {DRAWS} draws")

    port = [convert.frontend_output_from_numpy(jax.tree.map(np.asarray, p), device="cpu") for p in packets]
    outs = {}
    for threads in (1, 2, 4, 8):
        torch.set_num_threads(threads)
        runner = ttp.make_offline_runner(None, tc, 16, device="cpu")
        snaps = []
        for p in port:
            runner.add_packet(p)
            start = runner.window_due()
            if start is not None:
                runner.solve(start)
                snaps.append(runner.est.X.t.clone().numpy())
        outs[threads] = snaps
    worst = np.max([[np.abs(a - b).max() for a, b in zip(outs[1], outs[t])] for t in (2, 4, 8)], axis=0)
    print(f"4. port segment loop at 2, 4, 8 threads against 1: camera translations move by up to "
          f"{worst[0]:.3g} m after window 1, {worst[1]:.3g} m after window 2")

    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    runs = []
    for draw in range(DRAWS + 1):
        runner = ttp.make_offline_runner(None, tc, 16, device="cpu")
        snaps = []
        for p in packets:
            if draw:
                p = p._replace(static_obs=p.static_obs._replace(xyz=jiggle(p.static_obs.xyz, rng)))
            runner.add_packet(convert.frontend_output_from_numpy(jax.tree.map(np.asarray, p), device="cpu"))
            start = runner.window_due()
            if start is not None:
                runner.solve(start)
                snaps.append(runner.est.X.t.clone().numpy())
        runs.append(snaps)
    worst = np.max([[np.abs(a - b).max() for a, b in zip(runs[0], r)] for r in runs[1:]], axis=0)
    print(f"   port segment loop under the perturbation of item 3: camera translations move by up to "
          f"{worst[0]:.3g} m after window 1, {worst[1]:.3g} m after window 2 over {DRAWS} draws")


def full_batch_spread():
    from dynosam_tpu.backend import solver as jsolver
    from dynosam_tpu_torch.backend import formulation as tfm
    from dynosam_tpu_torch.backend import map as tmap
    from dynosam_tpu_torch.backend import schur as tschur
    from dynosam_tpu_torch.backend import solver as tsolver
    from dynosam_tpu_torch.backend.backend import lm_config

    scfg = ScenarioConfig(n_frames=8)
    packets = Scenario(scfg).frontend_outputs()
    kw = dict(use_full_batch_opt=True, use_schur=False)
    jc, tc = jcfg.BackendConfig(**kw), tcfg.BackendConfig(**kw)
    specs = jfm.world_motion_families(jc).robust
    lm = jsolver.LMConfig(max_iterations=30, cg_max_iterations=jc.cg_max_iterations, cg_tol=jc.cg_tol)

    @jax.jit
    def jax_solve(m):
        w = jmap.slice_window(m, 0, 8)
        masks = jfm.build_masks(w, jc)
        anchor = w.X_init[0]
        return jsolver.lm_optimize(lambda x: jfm.world_motion_residuals(x, w, masks, jc, anchor), specs,
                                   jfm.init_values(w, masks, jc), lm,
                                   gn_diag_fn=lambda x, sw: jfm.world_motion_gn_diag(x, sw, w, masks, jc))

    def port_solve(m):
        w = tmap.slice_window(m, 0, 8)
        masks = tfm.build_masks(w, tc)
        anchor = w.X_init[0]
        return tsolver.lm_optimize(
            lambda x: tfm.world_motion_residuals(x, w, masks, tc, anchor), tfm.world_motion_families(tc).robust,
            tfm.init_values(w, masks, tc), lm_config(tc),
            gn_diag_fn=lambda x, sw: tfm.world_motion_gn_diag(x, sw, w, masks, tc),
            normal_fn=lambda x, sw, r: tschur.world_motion_normal_product(x, sw, r, w, masks, tc, anchor))

    def spread(out, label):
        errs = [abs(e / out[0][0] - 1) for e, _ in out[1:]]
        dts = [np.abs(t - out[0][1]).max() for _, t in out[1:]]
        print(f"   {label}: final error moves by up to {max(errs):.3g} (relative), camera translations by "
              f"up to {max(dts):.3g} m")

    rng = np.random.default_rng(0)
    jout, tout = [], []
    torch.set_num_threads(2)
    for draw in range(DRAWS + 1):
        m = jmap.MeasurementMap.create(8, scfg.ns, scfg.nd, scfg.no)
        for k, p in enumerate(packets):
            if draw:
                p = p._replace(static_obs=p.static_obs._replace(xyz=jiggle(p.static_obs.xyz, rng)))
            m = jmap.update_map(m, p, k)
        r = jax_solve(m)
        jout.append((float(r.error), np.asarray(r.values["X"].t)))
        r = port_solve(convert.measurement_map_from_numpy(jax.tree.map(np.asarray, m), device="cpu"))
        tout.append((float(r.error), r.values["X"].t.numpy()))
    print(f"5. full-batch LM-PCG, 8 frames, over {DRAWS} draws of the perturbation:")
    spread(jout, "JAX")
    spread(tout, "port (2 threads)")
    print(f"   port against JAX, unperturbed: final error {abs(tout[0][0] / jout[0][0] - 1):.3g} (relative), "
          f"camera translations {np.abs(tout[0][1] - jout[0][1]).max():.3g} m")
    m = convert.measurement_map_from_numpy(jax.tree.map(np.asarray, jmap.MeasurementMap.create(
        8, scfg.ns, scfg.nd, scfg.no)), device="cpu")
    for k, p in enumerate(packets):
        tmap.update_map(m, convert.frontend_output_from_numpy(jax.tree.map(np.asarray, p), device="cpu"), k)
    threads = []
    for n in (1, 2, 4, 8):
        torch.set_num_threads(n)
        r = port_solve(m)
        threads.append((float(r.error), r.values["X"].t.numpy()))
    spread(threads, "port at 2, 4, 8 threads against 1")


def online_spread():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_backend_online as tb
    from dynosam_tpu import pipeline as jpipe
    from dynosam_tpu_torch import pipeline as tpipe

    torch.set_num_threads(2)
    print(f"6. online backend runs over {DRAWS} draws of the perturbation:")
    for name, (scfg, kw) in sorted(tb.RUNS.items()):
        packets = Scenario(scfg).frontend_outputs()
        rng = np.random.default_rng(0)
        jout, tout = [], []
        for draw in range(DRAWS + 1):
            pk = [p._replace(static_obs=p.static_obs._replace(xyz=jiggle(p.static_obs.xyz, rng))) if draw else p
                  for p in packets]
            jout.append(np.asarray(jpipe.run_from_packets(pk, tb._cfg(jcfg, scfg, **kw)).est.X.t))
            tout.append(tpipe.run_from_packets(tb._port_packets(pk), tb._cfg(tcfg, scfg, **kw),
                                               device="cpu").est.X.t.numpy())
        print(f"   {name}: camera translations move by up to {max(np.abs(x - jout[0]).max() for x in jout[1:]):.3g} m "
              f"(JAX), {max(np.abs(x - tout[0]).max() for x in tout[1:]):.3g} m (port); port against JAX "
              f"unperturbed {np.abs(tout[0] - jout[0]).max():.3g} m")


def one_step():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_schur as ts

    torch.set_num_threads(2)
    p = ts.build_problem()
    worst = max((ts.rel_err(getattr(p["jsys"], f), getattr(p["tsys"], f)), f) for f in p["tsys"]._fields)
    print(f"7. port against JAX on one linearisation: normal-system fields up to {worst[0]:.3g} ({worst[1]})")
    for lam in (1e-4, 1e-7):
        jd = ts._jax_step(p["jsys"], jnp.asarray(lam, jnp.float32))
        td = ts.tschur.schur_step(p["tsys"], torch.tensor(lam, dtype=torch.float32), 1e-6)
        print(f"   Schur step at lambda {lam:g}: " + ", ".join(
            f"{k} {ts.rel_err(jd[k], td[k]):.3g}" for k in ("X", "P", "sp", "dp")))


SECTIONS = {"lm": lm_spread, "loop": loop_spread, "full_batch": full_batch_spread, "online": online_spread,
            "one_step": one_step}

if __name__ == "__main__":
    for name in sys.argv[1:] or SECTIONS:
        SECTIONS[name]()
