"""Where the 8-frame LM-PCG lands with each preconditioner, in the JAX
package and in the port: the scenario of `tests/test_distributed.py:17-25`
at 6 LM iterations of 60 CG, float32 unless stated.

For each solve: the final error, the LM iterations, and max |dX_t| and
max |dH_t| (m) against JAX's `distributed_optimize` on `make_mesh(1)`
(the port's two-rank solves also against `make_mesh(2, tracks=1)`, and
the float64 one against the port's single-process float64 solve with the
same probes).  "Hutchinson" is 8 Rademacher probes an LM iteration: JAX's
from `fold_in(PRNGKey(0), it)`, passed to the port where it says so,
else the port's own generator seeded 0.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/lm_pcg_preconditioner.py

takes about 2 minutes on a CPU (two gloo ranks for the port's
distributed solves).
"""

import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dynosam_tpu.backend import formulation as jfm  # noqa: E402
from dynosam_tpu.backend import solver as jsolver  # noqa: E402
from dynosam_tpu.backend.map import MeasurementMap, slice_window, update_map  # noqa: E402
from dynosam_tpu.parallel.distributed_ba import distributed_optimize as jdo  # noqa: E402
from dynosam_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from dynosam_tpu.testing.simulator import Scenario, ScenarioConfig  # noqa: E402
from dynosam_tpu.utils.config import BackendConfig as JBackendConfig  # noqa: E402
from dynosam_tpu_torch.backend import formulation as tfm  # noqa: E402
from dynosam_tpu_torch.backend import solver as tsolver  # noqa: E402
from dynosam_tpu_torch.backend.map import slice_window as tslice  # noqa: E402
from dynosam_tpu_torch.testing.gloo import run_ranks  # noqa: E402
from dynosam_tpu_torch.utils.config import BackendConfig  # noqa: E402

from test_torch_distributed_ba import PYPATH, TIMEOUT, port_problem, single  # noqa: E402
from test_torch_solver import jax_probes  # noqa: E402


def main():
    sc = Scenario(ScenarioConfig(n_frames=8, n_static=40, n_objects=2, pts_per_object=12, ns=64, nd=32, no=4))
    m = MeasurementMap.create(8, 64, 32, 4)
    for k, pkt in enumerate(sc.frontend_outputs()):
        m = update_map(m, pkt, k)
    m = jax.tree.map(np.asarray, m)
    jc, lm = JBackendConfig(), jsolver.LMConfig(max_iterations=6, cg_max_iterations=60)
    w = slice_window(m, 0, 8)
    mk = jfm.build_masks(w, jc)
    anchor = w.X_init[0]
    specs = jfm.world_motion_families(jc).robust

    def jax_single(gn_diag_fn):
        return jax.jit(lambda v: jsolver.lm_optimize(lambda x: jfm.world_motion_residuals(x, w, mk, jc, anchor),
                                                     specs, v, lm, gn_diag_fn=gn_diag_fn))(jfm.init_values(w, mk, jc))

    ref = jdo(m, 8, jc, mesh=jmake_mesh(1), lm_cfg=lm)
    ref2 = jdo(m, 8, jc, mesh=jmake_mesh(2, tracks=1), lm_cfg=lm)
    rows = [("JAX distributed_optimize, make_mesh(1)", ref),
            ("JAX distributed_optimize, make_mesh(2, tracks=1)", ref2),
            ("JAX lm_optimize, analytic diagonal", jax_single(lambda x, sw: jfm.world_motion_gn_diag(x, sw, w, mk, jc))),
            ("JAX lm_optimize, Hutchinson", jax_single(None))]

    template = {k: jax.numpy.zeros(v.shape, jax.numpy.float32)
                for k, v in tsolver.zero_delta(single(port_problem(torch.float32), 0)["values"]).items()}
    given = [jax_probes(template, it) for it in range(lm.max_iterations)]
    port_lm = tsolver.LMConfig(max_iterations=6, cg_max_iterations=60)
    s = single(port_problem(torch.float32), 0)
    tw = tslice(port_problem(torch.float32), 0, 8)
    tc = BackendConfig()
    tmk = tfm.build_masks(tw, tc)
    rows.append(("port lm_optimize, analytic diagonal", tsolver.lm_optimize(
        s["residual_fn"], s["specs"], s["values"], port_lm, normal_fn=s["normal_fn"],
        gn_diag_fn=lambda v, sw: tfm.world_motion_gn_diag(v, sw, tw, tmk, tc))))
    rows.append(("port lm_optimize, Hutchinson, JAX's probes", tsolver.lm_optimize(
        s["residual_fn"], s["specs"], s["values"], port_lm, normal_fn=s["normal_fn"], probes=given.__getitem__)))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probes.pt")
        torch.save(given, path)
        two = dict(tracks=1, updater=0, x64=False)
        rows.append(("port distributed_optimize, 2 gloo ranks, JAX's probes",
                     run_ranks("test_torch_distributed_ba:dba_rank", 2, {**two, "probes_file": path}, TIMEOUT,
                               PYPATH)[0]))
    rows.append(("port distributed_optimize, 2 gloo ranks, own probes",
                 run_ranks("test_torch_distributed_ba:dba_rank", 2, two, TIMEOUT, PYPATH)[0]))
    f64 = run_ranks("test_torch_distributed_ba:dba_rank", 2, dict(two, x64=True), TIMEOUT, PYPATH)[0]
    s64 = single(port_problem(torch.float64), 0)
    ref64 = tsolver.lm_optimize(s64["residual_fn"], s64["specs"], s64["values"], port_lm, normal_fn=s64["normal_fn"])

    def t(x, key):
        v = x["values"] if isinstance(x, dict) else x.values
        return np.asarray(v[key].t, np.float64)

    def fields(x):
        if isinstance(x, dict):
            return x["initial_error"], x["error"], x["iterations"]
        return float(x.initial_error), float(x.error), int(x.iterations)

    print("| solve | initial error | final error | LM iterations | max |dX_t| to mesh(1) | max |dH_t| to mesh(1) "
          "| max |dX_t|, max |dH_t| to mesh(2) |")
    print("|---|---|---|---|---|---|---|")
    for name, x in rows:
        e0, e, n = fields(x)
        d1 = [float(np.abs(t(x, k) - t(ref, k)).max()) for k in ("X", "H")]
        d2 = [float(np.abs(t(x, k) - t(ref2, k)).max()) for k in ("X", "H")]
        print(f"| {name} | {e0:.6g} | {e:.6g} | {n} | {d1[0]:.4g} | {d1[1]:.4g} | {d2[0]:.4g}, {d2[1]:.4g} |")
    dx, dh = (float(np.abs(t(f64, k) - ref64.values[k].t.numpy()).max()) for k in ("X", "H"))
    print(f"float64, 2 gloo ranks against the single process (own probes): final error {f64['error']:.9g} "
          f"vs {float(ref64.error):.9g}, LM iterations {f64['iterations']} vs {ref64.iterations}, "
          f"max |dX_t| {dx:.3g} m, max |dH_t| {dh:.3g} m")


if __name__ == "__main__":
    main()
