"""The port's online backend (`dynosam_tpu_torch/backend/backend.py`:
`SlidingWindowTrigger`, `RGBDBackend`, the accessors,
`propagate_object_poses`, checkpoints; `utils/serialization.py`;
`pipeline.run_from_packets`) against the JAX package on simulator packets.

Tolerances:

* trigger starts, final partial window and estimate-store masks: equal;
* camera translations after the run: 3e-3 m for the sliding windows and
  5e-4 m for the full batch, the float32 floor `tests/f32_spread.py` item
  6 measures for these runs: a 1e-7 relative perturbation of the static
  measurements moves JAX's by up to 2.4e-3 and 3.5e-4 m and the port's by
  up to 2.9e-3 and 2.8e-4 m (three warm-started windows of 8 iterations
  each with Huber k 1e-4 drift that far); unperturbed they differ by
  1.7e-3 and 1.7e-4 m;
* `propagate_object_poses` with motion gaps of 1 to 4 frames: validity
  equal, poses within 1e-4 (slerp through float32 log/exp); centroids
  within 1e-5 m (float32 sums in another order);
* packets, checkpoints and replays: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu import pipeline as jpipe
from dynosam_tpu.backend import backend as jbe
from dynosam_tpu.core import lie as jlie
from dynosam_tpu.testing.simulator import ScenarioConfig
from dynosam_tpu.utils import config as jcfg
from dynosam_tpu.utils import serialization as jser
from dynosam_tpu_torch import convert
from dynosam_tpu_torch import pipeline as tpipe
from dynosam_tpu_torch.backend import backend as tbe
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.utils import config as tcfg
from dynosam_tpu_torch.utils import serialization as tser

from test_torch_schur import jax_packets, port_packets

torch.set_num_threads(2)


@pytest.mark.parametrize("size,overlap", [(10, 4), (5, 2), (3, 0)])
def test_sliding_window_trigger_matches_jax(size, overlap):
    j, t = jbe.SlidingWindowTrigger(size, overlap), tbe.SlidingWindowTrigger(size, overlap)
    starts = [(t.check(k), j.check(k)) for k in range(41)]
    assert all(a == b for a, b in starts)
    assert t.start == j.start
    assert [a for a, _ in starts if a is not None][:3] == [0, size - overlap, 2 * (size - overlap)]


def _cfg(mod, scfg, **backend):
    return mod.DynoConfig(
        backend=mod.BackendConfig(**backend),
        capacity=mod.CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd,
                                    max_objects=scfg.no, max_frames=scfg.n_frames))


RUNS = {
    # windows 5/2 over 10 frames: [0, 5), [3, 8) and the final [6, 10)
    "sliding": (ScenarioConfig(n_frames=10), dict(opt_window_size=5, opt_window_overlap=2, lm_max_iterations=8)),
    # 20 frames in one window, above schur_max_window 16: LM-PCG
    "full_batch": (ScenarioConfig(n_frames=20), dict(use_full_batch_opt=True, lm_max_iterations=15)),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def replay(request):
    scfg, kw = RUNS[request.param]
    jb = jpipe.run_from_packets(jax_packets(scfg), _cfg(jcfg, scfg, **kw))
    tb = tpipe.run_from_packets(port_packets(scfg), _cfg(tcfg, scfg, **kw), device="cpu")
    return request.param, jb, tb


def test_run_from_packets_matches_jax(replay):
    name, jb, tb = replay
    windows = [(s, w) for s, w, _, _ in tb.solves]
    if name == "sliding":
        assert windows == [(0, 5), (3, 5), (6, 4)]
        assert all(r.cg_iterations is None for _, _, r, _ in tb.solves)
    else:
        assert windows == [(0, 20)]
        assert len(tb.last_result.cg_iterations) == tb.last_result.iterations
    for _, _, r, _ in tb.solves:
        assert float(r.error) < float(r.initial_error)
    a, b = jax.tree.map(np.asarray, dataclasses.asdict(jb.est)), convert.frontend_output_to_numpy(
        tb.est._asdict())
    for f in ("static_valid", "dyn_valid", "X_valid", "motion_valid"):
        assert np.array_equal(a[f], b[f]), f
    assert b["X_valid"].all()
    np.testing.assert_allclose(b["X"].t, a["X"].t, rtol=0, atol=3e-3 if name == "sliding" else 5e-4)
    assert jb.trigger.start == tb.trigger.start and jb.n_frames == tb.n_frames


def _motions_with_gaps(F=24, O=4, seed=2):
    """Random motions and centroids over F frames for O objects; object o
    has a motion gap of o + 1 frames in the middle and a centroid gap
    elsewhere, so gaps of 1-4 frames (slerp-filled below 3) all occur."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.05, (F, O, 6)).astype(np.float32)
    H = jlie.se3_exp(jnp.asarray(xi))
    hvalid = np.ones((F, O), bool)
    hvalid[0] = False
    cvalid = np.ones((F, O), bool)
    for o in range(O):
        hvalid[8:8 + o + 1, o] = False
        hvalid[18, o] = o % 2 == 0
        cvalid[3 + o, o] = False
    hvalid[20:, 3] = False
    cvalid[21:, 3] = False
    cen = rng.normal(0, 3, (F, O, 3)).astype(np.float32)
    return H, hvalid, cen, cvalid


def test_propagate_object_poses_matches_jax():
    H, hvalid, cen, cvalid = _motions_with_gaps()
    jL, jv = jax.jit(jbe.propagate_object_poses)(H, jnp.asarray(hvalid), jnp.asarray(cen), jnp.asarray(cvalid))
    tL, tv = tbe.propagate_object_poses(SE3(torch.as_tensor(np.array(H.R)), torch.as_tensor(np.array(H.t))),
                                        torch.as_tensor(hvalid), torch.as_tensor(cen), torch.as_tensor(cvalid))
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert tv.numpy().sum() > hvalid.sum()               # the short gaps were filled
    np.testing.assert_allclose(tL.R.numpy(), np.asarray(jL.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tL.t.numpy(), np.asarray(jL.t), rtol=0, atol=1e-4)


def test_object_centroids_and_poses_match_jax():
    scfg = ScenarioConfig(n_frames=24)
    F, ND, O = scfg.n_frames, scfg.nd, scfg.no
    rng = np.random.default_rng(4)
    dp = rng.normal(0, 5, (F, ND, 3)).astype(np.float32)
    dv = rng.random((F, ND)) < 0.6
    obj = rng.integers(-1, O, (F, ND)).astype(np.int32)
    obj[:, :10] = 1                                     # object 1 seen on every frame
    dv[5:7] &= obj[5:7] != 2                            # object 2 unseen on frames 5-6
    H, hvalid, _, _ = _motions_with_gaps(F, O)
    jb = jbe.RGBDBackend(_cfg(jcfg, scfg).backend, _cfg(jcfg, scfg).capacity)
    tb = tbe.RGBDBackend(_cfg(tcfg, scfg).backend, _cfg(tcfg, scfg).capacity, device="cpu")
    jb.map = jb.map._replace(dyn_obj=jnp.asarray(obj))
    jb.est = dataclasses.replace(jb.est, dyn_points=jnp.asarray(dp), dyn_valid=jnp.asarray(dv), H=H,
                                 motion_valid=jnp.asarray(hvalid))
    tb.map = tb.map._replace(dyn_obj=torch.as_tensor(obj))
    tb.est = tb.est._replace(dyn_points=torch.as_tensor(dp), dyn_valid=torch.as_tensor(dv),
                             H=SE3(torch.as_tensor(np.array(H.R)), torch.as_tensor(np.array(H.t))),
                             motion_valid=torch.as_tensor(hvalid))
    (jc, jcv), (tc, tcv) = jb.object_centroids(), tb.object_centroids()
    assert np.array_equal(np.asarray(jcv), tcv.numpy())
    assert not tcv.numpy()[5:7, 2].any() and tcv.numpy()[:, 1].all()
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    (jL, jv), (tL, tv) = jb.object_poses(), tb.object_poses()
    assert np.array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(tL.t.numpy(), np.asarray(jL.t), rtol=0, atol=1e-4)


def _small():
    return ScenarioConfig(n_frames=10, n_static=30, n_objects=1, pts_per_object=10, ns=40, nd=16, no=2)


def _leaves_equal(a, b):
    a, b = convert.frontend_output_to_numpy(a), convert.frontend_output_to_numpy(b)
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) == 18
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_packet_round_trips(tmp_path):
    """Port save -> port load, JAX save -> port load and port save -> JAX
    load all give the packets back exactly (one leaf order)."""
    packets, tp = jax_packets(_small()), port_packets(_small())
    tser.save_packets(str(tmp_path / "port.npz"), tp)
    jser.save_packets(str(tmp_path / "jax.npz"), packets)
    for path in ("port.npz", "jax.npz"):
        loaded = tser.load_packets(str(tmp_path / path), device="cpu")
        assert len(loaded) == len(tp)
        for a, b in zip(tp, loaded):
            _leaves_equal(a, b)
    for a, b in zip(tp, jser.load_packets(str(tmp_path / "port.npz"))):
        _leaves_equal(a, jax.tree.map(np.asarray, b))


def test_offline_replay_matches_online(tmp_path):
    """Saved packets replayed through the backend give the same solve."""
    scfg = _small()
    packets = port_packets(scfg)
    tser.save_packets(str(tmp_path / "pk.npz"), packets)
    cfg = _cfg(tcfg, scfg, use_full_batch_opt=True, lm_max_iterations=8)
    b1 = tpipe.run_from_packets(packets, cfg, output_path=str(tmp_path / "out"), device="cpu")
    b2 = tpipe.run_from_packets(tser.load_packets(str(tmp_path / "pk.npz"), device="cpu"), cfg, device="cpu")
    assert torch.equal(b1.est.X.t, b2.est.X.t) and torch.equal(b1.est.dyn_points, b2.est.dyn_points)
    assert (tmp_path / "out" / "statistics_summary.csv").exists()


def test_backend_checkpoint_resume(tmp_path):
    """10 frames straight through equal 6 frames, a checkpoint restored into
    a fresh backend, and the last 4 frames (the port's
    `tests/test_checkpoint.py`)."""
    scfg = _small()
    packets = port_packets(scfg)
    cfg = _cfg(tcfg, scfg, opt_window_size=5, opt_window_overlap=2, lm_max_iterations=8)
    ba = tpipe.run_from_packets(packets, cfg, device="cpu")
    bb = tbe.RGBDBackend(cfg.backend, cfg.capacity, device="cpu")
    for pkt in packets[:6]:
        bb.spin(pkt)
    ck = str(tmp_path / "ck.pt")
    tbe.save_backend_checkpoint(bb, ck)
    bc = tbe.load_backend_checkpoint(tbe.RGBDBackend(cfg.backend, cfg.capacity, device="cpu"), ck)
    assert bc.n_frames == 6 and bc.trigger.start == bb.trigger.start == 3
    for pkt in packets[6:]:
        bc.spin(pkt)
    bc.finish()
    assert torch.equal(ba.est.X.t, bc.est.X.t) and torch.equal(ba.est.X_valid, bc.est.X_valid)
    other = tbe.RGBDBackend(cfg.backend, dataclasses.replace(cfg.capacity, max_frames=12), device="cpu")
    with pytest.raises(ValueError, match="the template has"):
        tbe.load_backend_checkpoint(other, ck)


def _pcg_reads(n_cg, max_iters, chunk):
    """Host reads of one `pcg` call that ran `n_cg` iterations: one after
    each chunk but a last one that reaches `max_iters`."""
    chunks = max(1, -(-n_cg // chunk))
    return chunks - 1 if n_cg == max_iters else chunks


def test_host_reads_per_spin(monkeypatch):
    """Every Python-level read of a tensor (`item`, `tolist`, `bool`,
    `int`, `float`, `numpy`) during the spins and the finish, counted: none
    on a frame without a solve, one per LM iteration in a direct-Schur
    window, and in the LM-PCG solve one per LM iteration plus one per CG
    chunk."""
    from dynosam_tpu_torch.backend import solver as tsolver

    reads = []
    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "numpy"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads.append(1)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    for name, (scfg, kw) in sorted(RUNS.items()):
        packets = port_packets(scfg)
        cfg = _cfg(tcfg, scfg, **kw)
        be = tbe.RGBDBackend(cfg.backend, cfg.capacity, device="cpu")
        per_spin = []
        for pkt in packets:
            n0, s0 = len(reads), len(be.solves)
            be.spin(pkt)
            per_spin.append((len(reads) - n0, [r.iterations for _, _, r, _ in be.solves[s0:]]))
        n0 = len(reads)
        be.finish()
        finish_reads = len(reads) - n0
        for got, its in per_spin:
            assert got == sum(its)
        r = be.last_result
        want = r.iterations
        if r.cg_iterations is not None:
            want += sum(_pcg_reads(n, cfg.backend.cg_max_iterations, tsolver.PCG_CHUNK) for n in r.cg_iterations)
        assert finish_reads == want, (name, finish_reads, want)
        assert any(its for _, its in per_spin) == (name == "sliding")
