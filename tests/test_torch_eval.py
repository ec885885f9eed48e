"""The port's evaluation and logs (`dynosam_tpu_torch/eval/metrics.py`,
`eval/evaluator.py`, `utils/logger.py`, `utils/stats.py`) against the JAX
package's on seeded numpy poses and motions.

Tolerances: every metric agrees to 1e-12 in float64; the CSV files the two
loggers write from the same rows are identical as text; `evaluate_all`
returns equal dicts (floats to 1e-12) on the same folder.
"""

import json
import os

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from dynosam_tpu.eval import evaluator as jev
from dynosam_tpu.eval import metrics as jmet
from dynosam_tpu.utils import logger as jlog
from dynosam_tpu.utils import stats as jstats
from dynosam_tpu_torch.eval import evaluator as tev
from dynosam_tpu_torch.eval import metrics as tmet
from dynosam_tpu_torch.utils import logger as tlog
from dynosam_tpu_torch.utils import stats as tstats


def poses(rng, n, scale=1.0):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.normal(0, 0.3 * scale, (n, 3))).as_matrix()
    T[:, :3, 3] = rng.normal(0, 2.0 * scale, (n, 3))
    return T


def perturbed(rng, T, s):
    return np.einsum("nij,njk->nik", T, poses(rng, len(T), s))


def assert_close(a, b, path="result"):
    """Nested dicts, lists, ErrorStats and arrays equal, floats to 1e-12."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_close(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (jmet.ErrorStats, tmet.ErrorStats)):
        assert_close(a.as_dict(), b.as_dict(), path)
    elif isinstance(a, (float, np.floating, np.ndarray)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("metric", ["ate_umeyama", "ate_best", "ate_unaligned", "rpe", "rpe_delta3", "ame",
                                    "rme", "umeyama_sim3", "empty_stats"])
def test_metrics_match_jax(metric):
    rng = np.random.default_rng(7)
    gt = poses(rng, 24)
    est = perturbed(rng, gt, 0.02)
    Lprev = poses(rng, 24)
    call = {
        "ate_umeyama": lambda m: m.ate(est, gt),
        "ate_best": lambda m: m.ate(est, gt, align_mode="best"),
        "ate_unaligned": lambda m: m.ate(est, gt, align=False),
        "rpe": lambda m: m.rpe(est, gt),
        "rpe_delta3": lambda m: m.rpe(est, gt, delta=3),
        "ame": lambda m: m.ame(est, gt),
        "rme": lambda m: m.rme(est, gt, Lprev),
        "umeyama_sim3": lambda m: m.umeyama_alignment(est[:, :3, 3], 1.3 * gt[:, :3, 3], with_scale=True),
        "empty_stats": lambda m: m.ErrorStats.from_errors(np.array([])),
    }[metric]
    a, b = call(jmet), call(tmet)
    if metric == "empty_stats":
        assert all(np.isnan(v) for v in b.as_dict().values())
        assert list(a.as_dict()) == list(b.as_dict())
        return
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
        return
    assert_close(a, b)


def _log_rows(logger_cls, out, rng_seed=3):
    """The same seeded rows through one package's logger: two modules,
    camera poses with and without GT, motions and poses of three objects
    (one without GT in some frames), points, timestamps and boxes."""
    rng = np.random.default_rng(rng_seed)
    X = poses(rng, 12)
    X_gt = perturbed(rng, X, 0.01)
    for prefix, with_gt in (("frontend", True), ("rgbd_motion_world_backend", False)):
        log = logger_cls(out, prefix)
        for k in range(12):
            log.log_camera_pose(k, X[k], X_gt[k] if with_gt else None)
            log.log_timestamp(k, 0.1 * k)
            for obj in (3, 4, 9):
                H = poses(rng, 1, 0.1)[0]
                L = poses(rng, 1)[0]
                has_gt = with_gt and not (obj == 9 and k % 3 == 0)
                log.log_object_motion(k, obj, H, perturbed(rng, H[None], 0.01)[0] if has_gt else None)
                log.log_object_pose(k, obj, L, perturbed(rng, L[None], 0.01)[0] if has_gt else None)
            log.log_map_point(k, 17 + k, rng.normal(size=3))
            log.log_bbox(k, 3, [1.0, 2.0, 30.5, 40.25])
        log.flush()


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("logs")
    jdir, tdir = str(root / "jax"), str(root / "port")
    _log_rows(jlog.EstimationLogger, jdir)
    _log_rows(tlog.EstimationLogger, tdir)
    return jdir, tdir


def test_logger_files_identical_as_text(logs):
    jdir, tdir = logs
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert len(names) == 12
    for name in names:
        with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
            assert a.read() == b.read(), name


def test_read_pose_log_matches_jax(logs):
    _, tdir = logs
    for prefix in ("frontend", "rgbd_motion_world_backend"):
        path = os.path.join(tdir, f"{prefix}_camera_pose_log.csv")
        a, b = jlog.read_pose_log(path), tlog.read_pose_log(path)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-12)
        assert (a[2] is None) == (b[2] is None) == (prefix != "frontend")


def test_evaluate_all_matches_jax(logs, tmp_path):
    _, tdir = logs
    a = jev.evaluate_all(tdir, save_json=False)
    b = tev.evaluate_all(tdir)
    assert set(b) == {"frontend", "rgbd_motion_world_backend"}
    assert set(b["frontend"]["objects"]) == {3, 4, 9}
    assert "camera" not in b["rgbd_motion_world_backend"]            # no GT columns
    assert_close(a, b)
    with open(os.path.join(tdir, "results.json")) as f:
        assert set(json.load(f)) == set(b)
    assert_close(jev.evaluate_module(tdir, "frontend"), tev.evaluate_module(tdir, "frontend"))


def test_stats_csvs_match_jax(tmp_path):
    """The statistics registry writes the JAX package's CSV layout."""
    for mod in (jstats, tstats):
        mod.reset()
        for i, v in enumerate((3.0, 1.0, 2.0, 8.0)):
            mod.add_sample("backend.spin [ms]", v)
            mod.add_sample("frontend.spin [ms]", 10.0 * i)
        with mod.timer("scope"):
            pass
    for name in ("samples", "summary"):
        for mod, tag in ((jstats, "j"), (tstats, "t")):
            getattr(mod, f"write_{name}_csv")(str(tmp_path / f"{tag}_{name}.csv"))
        a = (tmp_path / f"j_{name}.csv").read_text().splitlines()
        b = (tmp_path / f"t_{name}.csv").read_text().splitlines()
        # the timer's sample and the rate (hz) read the wall clock: the
        # timer's row is compared by tag (and count), the others up to hz
        assert len(a) == len(b) == 4
        for ra, rb in zip(a, b):
            n = (1 if name == "samples" else 2) if ra.startswith("scope") else (None if name == "samples" else 8)
            assert ra.split(",")[:n] == rb.split(",")[:n], (ra, rb)
    assert tstats.print_summary().splitlines()[0].startswith("backend.spin [ms]: n=4 mean=3.500")
    tstats.reset()
    jstats.reset()
