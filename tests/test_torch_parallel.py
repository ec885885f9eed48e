"""The port's mesh layer and frame-split SPIKE chain solve
(`dynosam_tpu_torch/parallel/mesh.py`, `multihost.py`,
`schur_dist.spike_chain_solve`) against the JAX package.

Multi-rank runs are gloo ranks on the CPU, one process each
(`dynosam_tpu_torch.testing.gloo.run_ranks`: a free port, one torch
thread, a timeout per rank).  JAX runs in this process on its virtual
8-device CPU mesh (`tests/conftest.py`); this module imports JAX only
inside the tests, so the ranks that import it stay light.

Tolerances: the SPIKE solve against the port's block-Thomas `chain_solve`
in float64 to 1e-10 relative (elimination order only); against JAX's
`make_spike_chain_solver` in float32 at `tests/test_distributed.py:72-97`'s
2e-4.  Shapes, placements and frame ranges exactly.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from dynosam_tpu_torch.testing.gloo import run_ranks

ROOT = Path(__file__).resolve().parent.parent
PYPATH = [str(ROOT), str(ROOT / "tests")]
TIMEOUT = 180


def chain_problem(dtype):
    """Random SPD block-tridiagonal chains (W 8, N 4, M 5), the
    construction of `tests/test_distributed.py:72-97`."""
    rng = np.random.default_rng(3)
    W, N, M = 8, 4, 5
    A = np.zeros((W, N, 3, 3))
    B = np.zeros((W, N, 3, 3))
    rhs = rng.normal(size=(W, N, 3, M))
    for n in range(N):
        C = np.zeros((3 * W, 3 * W))
        for k in range(W):
            C[3 * k:3 * k + 3, 3 * k:3 * k + 3] = rng.normal(size=(3, 3))
            if k > 0:
                C[3 * k:3 * k + 3, 3 * k - 3:3 * k] = rng.normal(size=(3, 3))
        G = C @ C.T + np.eye(3 * W)
        for k in range(W):
            A[k, n] = G[3 * k:3 * k + 3, 3 * k:3 * k + 3]
            if k > 0:
                B[k, n] = G[3 * k - 3:3 * k, 3 * k:3 * k + 3]
    return [x.astype(dtype) for x in (A, B, rhs)]


def mesh_rank(rank, world, tracks):
    """One gloo rank: its mesh coordinates and frame range, its block of
    the SPIKE solve (float64, float32), the map blocks of both layouts and
    the all_gather of `host_local_to_global`."""
    from dynosam_tpu_torch.backend.map import MeasurementMap
    from dynosam_tpu_torch.parallel import mesh as pm
    from dynosam_tpu_torch.parallel import multihost
    from dynosam_tpu_torch.parallel.schur_dist import spike_chain_solve

    mesh = pm.make_mesh(tracks=tracks)
    out = {"coords": pm.mesh_coords(mesh), "frames": multihost.local_frame_range(mesh, 8)}
    for name, dt in (("x64", np.float64), ("x32", np.float32)):
        A, B, rhs = (torch.as_tensor(x) for x in chain_problem(dt))
        out[name] = spike_chain_solve(A, B, rhs, mesh)
    m = MeasurementMap.create(8, 6, 4, 2)
    m.static_xyz.copy_(torch.arange(8 * 6 * 3, dtype=torch.float32).reshape(8, 6, 3))
    m.dyn_obj.copy_(torch.arange(32, dtype=torch.int32).reshape(8, 4))
    out["feed"] = pm.shard_map_data(m, mesh, "feed").local
    out["compute"] = pm.shard_map_data(m, mesh, "compute").local
    out["gathered"] = pm.host_local_to_global({"dyn_obj": out["feed"].dyn_obj}, mesh)["dyn_obj"]
    return out


@pytest.fixture(scope="module", params=[(2, 1), (4, None)], ids=["2x1", "4_default"])
def ranks(request):
    world, tracks = request.param
    return world, run_ranks("test_torch_parallel:mesh_rank", world, {"tracks": tracks}, TIMEOUT, PYPATH)


def _assemble(ranks_out, key, F, T):
    blocks = {o["coords"][:2]: o[key] for o in ranks_out}
    return torch.cat([torch.cat([blocks[(f, t)] for t in range(T)], dim=1) for f in range(F)], dim=0)


@pytest.mark.parametrize("n,tracks", [(1, None), (2, None), (4, None), (8, None), (8, 1), (8, 4), (4, 2)])
def test_mesh_shape_policy_matches_jax(n, tracks):
    from dynosam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from dynosam_tpu_torch.parallel.mesh import mesh_shape

    assert mesh_shape(n, tracks) == jmake_mesh(n, tracks).devices.shape
    with pytest.raises(ValueError, match="must divide"):
        mesh_shape(6, 4)


def test_placements_match_jax_partition_specs():
    """Every leaf of the feed, compute and values layouts splits the same
    tensor dims over the same mesh axes as JAX's PartitionSpecs
    (`tests/test_distributed.py:28-33`)."""
    import jax

    from dynosam_tpu.parallel import mesh as jm
    from dynosam_tpu_torch.parallel import mesh as tm

    jmesh = jm.make_mesh(8)

    def jspec(s):
        spec = tuple(s.spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec

    pairs = [(jm.map_shardings(jmesh), tm.map_shardings()), (jm.map_compute_shardings(jmesh), tm.map_compute_shardings())]
    for f in (0, 1):     # JAX flattens dicts in key order
        jv, tv = jm.values_shardings(jmesh, f), tm.values_shardings(None, f)
        assert list(jv) == list(tv)
        pairs += [(jv[k], tv[k]) for k in jv]
    n = 0
    for jtree, ttree in pairs:
        jleaves = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        tleaves = [p for _, p in tm_leaves(ttree)]
        assert len(jleaves) == len(tleaves)
        for js, tp in zip(jleaves, tleaves):
            assert jspec(js) == tm.partition_spec(tp)
            n += 1
    assert n == 2 * 18 + 2 * 6
    assert tm.partition_spec(tm.map_shardings().dyn_xyz) == ("frames", "tracks")


def tm_leaves(tree):
    from dynosam_tpu_torch.parallel.mesh import tree_map2

    out = []
    tree_map2(lambda x, p: out.append((x, p)) or x, tree, tree)
    return out


def test_frame_ranges_and_layouts_match_jax(ranks):
    """Each rank's mesh coordinates and `local_frame_range` against JAX's
    device index map of P(frames) on `make_mesh(2)` / `make_mesh(4)`; the
    map blocks of both layouts and `host_local_to_global`."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dynosam_tpu.parallel.mesh import make_mesh as jmake_mesh

    world, out = ranks
    jmesh = jmake_mesh(world)
    F, T = jmesh.devices.shape
    idx = NamedSharding(jmesh, P("frames")).devices_indices_map((8,))
    for r, o in enumerate(out):
        f, t = divmod(r, T)
        assert o["coords"] == (f, t, F, T)
        (sl,) = idx[jmesh.devices[f, t]]
        assert o["frames"] == (sl.start or 0, 8 if sl.stop is None else sl.stop)
        S, n = 8 // F, 4 // T
        full = torch.arange(32, dtype=torch.int32).reshape(8, 4)
        assert torch.equal(o["feed"].dyn_obj, full[f * S:(f + 1) * S, t * n:(t + 1) * n])
        assert o["feed"].static_xyz.shape == (S, 6, 3)
        assert o["compute"].static_xyz.shape == (8, 6 // T, 3)
        assert torch.equal(o["compute"].X_init.t, torch.zeros(8, 3))
        assert torch.equal(o["gathered"], full[:, t * n:(t + 1) * n])


@functools.lru_cache(maxsize=None)
def jax_spike_chain_solver(world):
    """JAX's `make_spike_chain_solver` on `make_mesh(world)` under one
    `jax.jit`, as the JAX package's window solve runs it (called eagerly,
    its shard_map compiles every primitive anew on each call)."""
    import jax

    from dynosam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from dynosam_tpu.parallel.schur_dist import make_spike_chain_solver

    return jax.jit(make_spike_chain_solver(jmake_mesh(world)))


def test_spike_chain_solve_matches_thomas_and_jax(ranks):
    """The frame-split SPIKE solve, assembled from every rank's block,
    equals the port's block-Thomas `chain_solve` in float64 (1e-10
    relative) and JAX's `make_spike_chain_solver` on the same mesh shape in
    float32 (2e-4)."""
    import jax.numpy as jnp

    from dynosam_tpu_torch.backend.schur import chain_solve

    world, out = ranks
    F, T = out[0]["coords"][2:]
    A, B, rhs = (torch.as_tensor(x) for x in chain_problem(np.float64))
    want = chain_solve(A, B, rhs)
    got = _assemble(out, "x64", F, T)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-10

    A32, B32, rhs32 = chain_problem(np.float32)
    jgot = np.asarray(jax_spike_chain_solver(world)(jnp.asarray(A32), jnp.asarray(B32), jnp.asarray(rhs32)))
    np.testing.assert_allclose(_assemble(out, "x32", F, T).numpy(), jgot, rtol=2e-4, atol=2e-4)


def test_make_mesh_needs_a_process_group():
    from dynosam_tpu_torch.parallel.mesh import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
