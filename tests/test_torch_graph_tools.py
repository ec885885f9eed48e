"""The port's graph tools (`dynosam_tpu_torch/backend/graph_tools.py`)
against the JAX package's, after `tests/test_tools.py:13-45,166-211`:
outlier masks, `DebugInfo` and `SparsityStats` equal, and the graph file
and the Graphviz dot byte for byte equal on the same masks and values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.backend import formulation as jfm
from dynosam_tpu.backend import graph_tools as jgt
from dynosam_tpu.backend.solver import RobustSpec as JRobustSpec
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils.config import BackendConfig as JBackendConfig
from dynosam_tpu_torch.backend import graph_tools as tgt
from dynosam_tpu_torch.backend.solver import RobustSpec

from test_torch_schur import _window, to_port


def test_factor_outliers_match_jax():
    """The reference sample (2 small, 1 large, 1 masked row) and random
    families of dimensions 2, 3 and 6, robust and not."""
    r = np.asarray([[1e-5, 0, 0], [2e-5, 0, 0], [5.0, 5.0, 5.0], [0, 0, 0]], np.float32)
    out = tgt.factor_outliers([torch.as_tensor(r)], [RobustSpec("huber", 1e-4)])[0]
    assert out.tolist() == [False, False, True, False]
    rng = np.random.default_rng(1)
    fams = [rng.normal(0, 3, (7, 5, d)).astype(np.float32) for d in (2, 3, 6, 4)]
    fams[1][2] = 0.0
    kinds = [("huber", 1.0), ("none", 1.0), ("tukey", 0.5), ("cauchy", 2.0)]
    j = jgt.factor_outliers([jnp.asarray(f) for f in fams], [JRobustSpec(*k) for k in kinds])
    t = tgt.factor_outliers([torch.as_tensor(f) for f in fams], [RobustSpec(*k) for k in kinds])
    for a, b in zip(j, t):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert any(b.any() for b in t) and not t[1].any()


def test_debug_info_and_sparsity_match_jax():
    scfg = ScenarioConfig(n_frames=6, n_static=30, n_objects=1, pts_per_object=10, ns=40, nd=32, no=4)
    _, _, _, _, jmk, tmk = _window(scfg)
    info = tgt.DebugInfo.from_masks(tmk)
    assert info == tgt.DebugInfo(**vars(jgt.DebugInfo.from_masks(jmk)))
    assert (info.num_poses, info.num_static_points, info.num_static_factors, info.num_motion_factors,
            info.num_odometry_factors) == (6, 30, 180, 50, 5)
    st = tgt.sparsity_stats(tmk)
    assert vars(st) == vars(jgt.sparsity_stats(jmk))
    assert 0.0 < st.fill_ratio < 0.2


@pytest.mark.parametrize("updater", [0, 1])
def test_graph_file_and_dot_equal_jax_bytes(tmp_path, updater):
    """The graph file and the dot of the same window (both formulations'
    value sets, the values handed over as the port's tensors) are byte for
    byte the JAX package's."""
    scfg = ScenarioConfig(n_frames=4, n_static=10, n_objects=1, pts_per_object=5, ns=16, nd=16, no=2)
    jw, tw, _, _, jmk, tmk = _window(scfg)
    jc = JBackendConfig()
    jv = (jfm.init_values if updater == 0 else jfm.init_values_world_pose)(jw, jmk, jc)
    key = "hl"[updater]
    n_j = jgt.write_dynosam_graph_file(str(tmp_path / "j.txt"), jv, jmk, pose_key=key, dyn_obj=jw.dyn_obj)
    n_t = tgt.write_dynosam_graph_file(str(tmp_path / "t.txt"), to_port(jv), tmk, pose_key=key, dyn_obj=tw.dyn_obj)
    assert n_t == n_j > 0
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    text = (tmp_path / "t.txt").read_text()
    info = tgt.DebugInfo.from_masks(tmk)
    assert text.count("SE3_POSE_VALUE") == info.num_poses and "SE3_PRIOR_FACTOR x0" in text
    jgt.save_graph_dot(str(tmp_path / "j.dot"), jmk, pose_key=key, dyn_obj=jw.dyn_obj)
    tgt.save_graph_dot(str(tmp_path / "t.dot"), tmk, pose_key=key, dyn_obj=tw.dyn_obj)
    assert (tmp_path / "t.dot").read_bytes() == (tmp_path / "j.dot").read_bytes()
    assert (tmp_path / "t.dot").read_text().startswith("graph dynosam {")
