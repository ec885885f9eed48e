"""Drift recovery (`tests/test_accuracy_regression.py:166-228`) on the port,
held against the JAX package on the CPU at a capped LM iteration count.

The golden scene's frontend packets (the port's renderer and frontend,
`testing/scenes.py:golden_dataset`) get the growing camera drift of the
JAX test; both packages' `run_from_packets` replay the same corrupted
packets through the full-batch backend with the loosened odometry sigmas
of that test, for updater 0 and updater 1.  The full 100-iteration
recovery takes about 55 s per updater on a CPU (PERF.md), so here both
solves stop after `CAP` LM iterations: the port's final error and
recovered camera ATE stay within twice the float32 floor measured here
(the spread of JAX's solve and of the port's when the packets' static and
dynamic measurements move by one part in 1e7, `DRAWS` draws), and the
ATE has already dropped below the corrupted one.  The full recovery with
JAX's bounds runs on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`'s golden phase).
"""

import dataclasses
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu import pipeline as jpipe
from dynosam_tpu.utils import serialization as jser
from dynosam_tpu_torch.core.lie import se3_compose, se3_exp
from dynosam_tpu_torch.eval import metrics
from dynosam_tpu_torch.pipeline import DynoPipeline, run_from_packets
from dynosam_tpu_torch.testing.scenes import GOLDEN_FRAMES, golden_config, golden_dataset
from dynosam_tpu_torch.utils import serialization as tser

from test_accuracy_regression import _make_cfg

torch.set_num_threads(2)

CAP = 3
DRAWS = 2
DRIFT_PER_FRAME = (0.0, 0.0015, 0.0, 0.02, 0.008, 0.0)


@pytest.fixture(scope="module")
def corrupted():
    """(port packets, JAX packets, ground-truth poses (F, 4, 4)) of the
    golden scene with the drift of the JAX test."""
    ds = golden_dataset("cpu")
    cfg = dataclasses.replace(golden_config(True), pipeline=dataclasses.replace(golden_config().pipeline,
                                                                                use_backend=False))
    packets = DynoPipeline(ds.camera_params(), cfg, device="cpu").run(ds.frames()).packets
    drift = torch.tensor(DRIFT_PER_FRAME)
    tp = [p._replace(X_world=se3_compose(se3_exp(drift * float(k)), p.X_world)) for k, p in enumerate(packets)]
    with tempfile.TemporaryDirectory() as d:
        tser.save_packets(f"{d}/pk.npz", tp)
        jp = jser.load_packets(f"{d}/pk.npz")
    gt = np.stack([ds.ground_truth(k).X_world for k in range(GOLDEN_FRAMES)])
    return tp, jp, gt


def _ate(R, t, valid, gt):
    T = np.tile(np.eye(4), (int(valid.sum()), 1, 1))
    T[:, :3, :3] = np.asarray(R, np.float64)[valid]
    T[:, :3, 3] = np.asarray(t, np.float64)[valid]
    return metrics.ate(T, gt[valid])["trans"].rmse


def _jiggled(packets, rng, module):
    """The packets with their static and dynamic measurements scaled by
    (1 + 1e-7 N(0, 1)): `module` torch for the port's, `_Np` for JAX's (the
    product in numpy float32, then one `jnp.asarray`) or `_Jnp` (the `jnp`
    form `test_jiggled_jax_packets_in_numpy_equal_jnp` holds `_Np` to)."""
    def j(x):
        return module.scale(x, rng.standard_normal(tuple(x.shape)).astype(np.float32))

    return [p._replace(static_obs=p.static_obs._replace(xyz=j(p.static_obs.xyz)),
                       dynamic_obs=p.dynamic_obs._replace(xyz=j(p.dynamic_obs.xyz))) for p in packets]


class _Torch:
    @staticmethod
    def scale(x, z):
        return x * (1 + 1e-7 * torch.as_tensor(z))


class _Jnp:
    @staticmethod
    def scale(x, z):
        return x * (1 + 1e-7 * jnp.asarray(z))


class _Np:
    @staticmethod
    def scale(x, z):
        return jnp.asarray(np.asarray(x) * (np.float32(1) + np.float32(1e-7) * z))


def test_jiggled_jax_packets_in_numpy_equal_jnp(corrupted):
    """`_jiggled` of JAX's packets in numpy float32 has the bits of the
    `jnp` form it replaces, over the `DRAWS` draws the floor takes."""
    jp = corrupted[1]
    rng, ref = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(DRAWS):
        for a, b in zip(_jiggled(jp, rng, _Np), _jiggled(jp, ref, _Jnp)):
            for x, y in ((a.static_obs.xyz, b.static_obs.xyz), (a.dynamic_obs.xyz, b.dynamic_obs.xyz)):
                assert x.dtype == y.dtype == jnp.float32
                assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("updater", [0, 1])
def test_drift_recovery_capped_matches_jax(corrupted, updater):
    tp, jp, gt = corrupted
    Tc = np.stack([np.block([[p.X_world.R.double().numpy(), p.X_world.t.double().numpy()[:, None]],
                             [np.zeros((1, 3)), np.ones((1, 1))]]) for p in tp])
    corrupted_ate = metrics.ate(Tc, gt)["trans"].rmse
    assert corrupted_ate > 0.08, corrupted_ate

    def capped(cfg):
        return dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, backend_updater_enum=updater, lm_max_iterations=CAP,
            odometry_translation_sigma=1.0, odometry_rotation_sigma=0.5))

    jcfg, tcfg = capped(_make_cfg(True, updater)), capped(golden_config(True))

    def jax_solve(pk):
        b = jpipe.run_from_packets(pk, jcfg)
        X, xv = b.camera_poses()
        return float(b.last_result.error), _ate(X.R, X.t, np.asarray(xv), gt)

    def port_solve(pk):
        b = run_from_packets(pk, tcfg, device="cpu")
        X, xv = b.camera_poses()
        assert b.last_result.iterations == CAP
        return float(b.last_result.error), _ate(X.R.numpy(), X.t.numpy(), xv.numpy(), gt)

    rng = np.random.default_rng(0)
    jruns = [jax_solve(jp)] + [jax_solve(_jiggled(jp, rng, _Np)) for _ in range(DRAWS)]
    rng = np.random.default_rng(0)
    truns = [port_solve(tp)] + [port_solve(_jiggled(tp, rng, _Torch)) for _ in range(DRAWS)]

    def spread(runs, i):
        v0 = runs[0][i]
        return max(abs(r[i] / v0 - 1) for r in runs[1:])

    assert truns[0][1] < corrupted_ate and jruns[0][1] < corrupted_ate
    for i in (0, 1):                                     # final error, recovered ATE (relative)
        diff = abs(truns[0][i] / jruns[0][i] - 1)
        assert diff <= 2 * (spread(jruns, i) + spread(truns, i)), (i, diff, jruns, truns)
