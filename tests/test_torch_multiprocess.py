"""The port's multi-process worker (`dynosam_tpu_torch/parallel/mp_worker.py`)
across real process boundaries, as `tests/test_multiprocess.py` runs JAX's.

Two worker processes join a gloo group on a free localhost port
(`--device cpu`), feed their own keyframe blocks through
`multihost.feed_measurement_map`, run the frame-split direct-Schur solve
over `multihost.global_mesh` and compare it with the single-process solve
on their device, in float64: max |dX_t| and the relative error change
below 1e-6 (updater 0) and 2e-5 (updater 1).  Each worker has a timeout,
so a hang fails the test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dynosam_tpu_torch.testing.gloo import free_port

REPO = Path(__file__).resolve().parent.parent


def _spawn_workers(n: int, updater: int, tmp_path, timeout=240):
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs, outs = [], []
    for i in range(n):
        out = tmp_path / f"verdict_{updater}_{i}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynosam_tpu_torch.parallel.mp_worker", "--process-id", str(i),
             "--num-processes", str(n), "--port", str(port), "--out", str(out), "--updater", str(updater),
             "--device", "cpu"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return [json.loads(o.read_text()) for o in outs]


@pytest.mark.parametrize("updater", [0, 1])
def test_two_process_schur_equivalence(updater, tmp_path):
    verdicts = _spawn_workers(2, updater, tmp_path)
    tol = 1e-6 if updater == 0 else 2e-5
    for v in verdicts:
        assert v["num_processes"] == 2 and v["n_devices"] == 2
        assert v["backend"] == "gloo" and v["device"] == "cpu" and v["x64"] is True
        assert v["max_abs_dX_t"] < tol, v
        assert v["rel_derr"] < tol, v
        assert v["iterations"][0] == v["iterations"][1], v
        assert v["ok"], v
    assert verdicts[0]["dist_error"] == verdicts[1]["dist_error"]
