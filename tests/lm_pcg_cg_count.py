"""Suspected fault S1: does the port's full-batch LM-PCG need more CG
iterations than JAX's?  Both packages build the first LM system of the
golden full batch (the 32-frame golden scene of
`tests/test_accuracy_regression.py:45-91`, one LM-PCG solve over all
frames) from the same measurements and run their own `pcg` on it, with
the backend's cap of 100 CG iterations and tolerance 1e-6, and again with
the cap raised to 2000 (how far each is from converging).

The golden packets come from the port's golden frontend on the CPU
(`testing/scenes.py:golden_dataset`, `golden_config`) and reach the JAX
package through the npz packet format both packages read
(`utils/serialization.py`); the JAX map built from them is the window
both solve (`tests/test_torch_solver.py:first_lm_systems`).  Diagonal:
the analytic `world_motion_gn_diag` (what the full batch uses), or
Hutchinson's estimate over JAX's probes of LM iteration 0; float32, and
float64 with the rotations re-orthonormalised (`window_as`), where b and
A_mv on 3 seeded vectors are also compared.  Seconds are host seconds on
the CPU (JAX: a second, compiled call).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/lm_pcg_cg_count.py

takes about 5 minutes on a CPU.
"""

import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dynosam_tpu.backend import map as jmap  # noqa: E402
from dynosam_tpu.utils.config import BackendConfig as JBackendConfig  # noqa: E402
from dynosam_tpu.utils.serialization import load_packets as jload_packets  # noqa: E402
from dynosam_tpu_torch.pipeline import DynoPipeline  # noqa: E402
from dynosam_tpu_torch.testing.scenes import GOLDEN_FRAMES, golden_config, golden_dataset  # noqa: E402
from dynosam_tpu_torch.utils.serialization import save_packets  # noqa: E402

from test_torch_solver import first_lm_systems, system_rel_err, window_as  # noqa: E402

CAPS = (100, 2000)


def golden_window():
    """(JAX window over the golden full batch, JAX config, port config)."""
    cfg = golden_config(True)
    ds = golden_dataset("cpu")
    pipe = DynoPipeline(ds.camera_params(), cfg, device="cpu")
    packets = [pipe.spin_once(f) for f in ds.frames()]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "golden_packets.npz")
        save_packets(path, packets)
        jpackets = jload_packets(path)
    cap = cfg.capacity
    m = jmap.MeasurementMap.create(GOLDEN_FRAMES, cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects)
    for k, p in enumerate(jpackets):
        m = jmap.update_map(m, p, k)
    b = cfg.backend
    jc = JBackendConfig(use_full_batch_opt=True, backend_updater_enum=0, lm_max_iterations=b.lm_max_iterations)
    return jmap.slice_window(m, 0, GOLDEN_FRAMES), jc, b


def main():
    torch.set_num_threads(4)
    jw, jc, tc = golden_window()
    print(f"golden full batch: {GOLDEN_FRAMES} frames; cg_tol {tc.cg_tol}; CPU, torch {torch.__version__}, "
          f"JAX {jax.__version__}")
    print("| diagonal | dtype | CG cap | JAX CG its | JAX |r|^2/|b|^2 | JAX s | port CG its | port |r|^2/|b|^2 "
          "| port s | b, A_mv rel. diff |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for hutchinson in (False, True):
        for dtype in (np.float32, np.float64):
            nw = window_as(jw, dtype)
            shapes = {"X": (GOLDEN_FRAMES, 6), "H": (*np.asarray(nw.motion_valid).shape, 6),
                      "sp": (np.asarray(nw.static_xyz).shape[1], 3), "dp": (*np.asarray(nw.dyn_xyz).shape[:2], 3)}
            rng = np.random.default_rng(11)
            vecs = [{k: rng.normal(size=s) for k, s in shapes.items()} for _ in range(3 if dtype == np.float64 else 0)]
            for cap in CAPS:
                out = first_lm_systems(nw, jc, tc, vecs if cap == CAPS[0] else [], cap, tc.cg_tol, hutchinson)
                j, t = out["jax"], out["port"]
                diff = "-"
                if j["A"]:
                    diff = (f"{system_rel_err(j['b'], t['b']):.2g}, "
                            f"{max(system_rel_err(a, b) for a, b in zip(j['A'], t['A'])):.2g}")
                print(f"| {'Hutchinson (JAX probes)' if hutchinson else 'analytic'} | {np.dtype(dtype).name} | {cap} "
                      f"| {j['n']} | {j['ratio']:.3e} | {j['seconds']:.3f} | {t['n']} | {t['ratio']:.3e} "
                      f"| {t['seconds']:.3f} | {diff} |", flush=True)


if __name__ == "__main__":
    main()
