"""Kernels K5 (the refinement rounds, wrapper `frontend/refine.py:run_rounds`)
and K6 (the motion RANSAC, wrapper `ops/ransac.py:hypotheses_and_polish`)
on the CPU, where their wrappers run the plain versions: the arguments
the wrappers lay out for the kernels (`refine.pack`, `kernels/ransac.py:pack`)
and the outputs they read back (`refine.unpack`) against the plain versions,
bit for bit:

- K5 on the golden scene's frame-1 refinement inputs, both kinds (the joint
  flow + pose refinement of the ego pose and the objects, and the
  motion-only refinement): the plain version on what `pack` lays out (read
  back as `csrc/refine.cu` reads it) and `unpack` of its outputs equal the
  plain rounds;
- K6 in 3d2d with `score_cap` and in 3d3d, with hypothesis indices drawn
  by the JAX package: the plain version on what `pack` lays out, then the
  scatter, equals `ops/ransac.py:ransac_rigid`;
- the step with every K5 and K6 call routed through the kernels' argument
  layouts (the kernels replaced by their plain versions on those
  arguments) equals the CPU's step bit for bit, eagerly and replayed over
  fixed buffers, with two replays a frame.

The JAX parity of the same code is held by `tests/test_torch_refine.py`
and `tests/test_torch_ransac.py`; the kernels themselves against these
plain versions by `tests/test_torch_cuda.py` and `chip_smoke.py` on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.core.camera import CameraParams as JCam
from dynosam_tpu.ops import ransac as jran
from dynosam_tpu_torch import convert
from dynosam_tpu_torch.core.camera import CameraParams
from dynosam_tpu_torch.core.lie import SE3
from dynosam_tpu_torch.frontend import frontend as fe
from dynosam_tpu_torch.frontend import refine
from dynosam_tpu_torch.frontend.frontend import FrontendState, frontend_step
from dynosam_tpu_torch.kernels import ransac as ransac_kernel
from dynosam_tpu_torch.kernels import refine as refine_kernel
from dynosam_tpu_torch.ops import ransac as tran
from dynosam_tpu_torch.testing.scenes import golden_config, golden_dataset
from dynosam_tpu_torch.utils import graphs

torch.set_num_threads(2)
CPU = torch.device("cpu")
leaves = torch.utils._pytree.tree_leaves


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _state(cfg):
    cap = cfg.capacity
    return FrontendState.create(cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects, device=CPU)


@pytest.fixture(scope="module")
def golden():
    ds = golden_dataset(CPU)
    return ds.camera_params(), golden_config(False), [ds.frame(i) for i in range(4)]


@pytest.fixture(scope="module")
def frame_one_refinements(golden):
    """Each refinement of the golden scene's frame-1 step: (kind, P, valid,
    start), recorded where the step calls K5's wrapper."""
    cam, cfg, frames = golden
    g = torch.Generator().manual_seed(0)
    state = frontend_step(_state(cfg), frames[0], frames[0], cam, cfg.frontend, generator=g, first_frame=True,
                          device=CPU)[0]
    rec, real = {}, refine.run_rounds

    def recording(kind, P, R0):
        rec[type(kind).__name__] = (kind, P, R0["active"].clone(), {k: v.clone() for k, v in R0["carried"].items()})
        return real(kind, P, R0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(refine, "run_rounds", recording)
        c = fe._step_settings(cam, cfg.frontend, True, False, g)
        fe._run_eagerly({"in": dict(state=state, prev=frames[0], images=frames[1],
                                    u=fe._draw_uniforms(state, cfg.frontend, False, g, CPU))}, c)
    return rec


def _pose(p, batch):
    return SE3(p[..., :9].reshape(*batch, 3, 3).contiguous(), p[..., 9:].contiguous())


def k5_on_the_cpu(kid, fparams, iparams, rows, start, glob0, shared, valid):
    """A stand-in for K5 on its arguments: the refinement and the rounds'
    start read back from them as `csrc/refine.cu` reads them, the plain
    rounds, and their final state laid out as the kernel's outputs."""
    cam = CameraParams(*fparams[:4])
    s0, s1, k = fparams[4:7]
    max_iterations, outlier_rounds = iparams
    bsz = rows.shape[0]
    if kid == refine_kernel.FLOW_POSE:
        kind = refine.FlowPose(cam, s0, s1, k, max_iterations, outlier_rounds)
        P = dict(X_init=_pose(glob0, (bsz,)), X_prev=_pose(shared, ()), kp_prev=rows[..., 0:2].contiguous(),
                 depth_prev=rows[..., 2].contiguous(), flow_init=rows[..., 3:5].contiguous(),
                 p_world=rows[..., 5:8].contiguous())
        st = {"flow": start}
    else:
        kind = refine.MotionOnly(cam, s1, s0, k, max_iterations, outlier_rounds)
        Xs = _pose(shared.reshape(2, 12), (2,))
        mp, mc = start[..., :3].contiguous(), start[..., 3:].contiguous()
        P = dict(H_init=_pose(glob0, (bsz,)), m_prev_world=mp, m_cur_init=mc, Xs_R=Xs.R[:, None, None],
                 Xs_t=Xs.t[:, None, None], uvs=torch.stack([rows[..., 0:2], rows[..., 2:4]]))
        st = {"mp": mp, "mc": mc}
    return _as_outputs(kind, refine.rounds_plain(kind, P, refine.rounds_start(kind, valid, st)))


def _as_outputs(kind, R):
    """The rounds' final state laid out as K5's outputs."""
    g = R["res"][kind.glob]
    return (torch.cat([R["carried"][key] for key in kind.keys], dim=-1), R["active"],
            torch.cat([g.R.reshape(-1, 9), g.t], dim=-1), R["error"], R["n_new"], R["it"])


@pytest.mark.parametrize("name", ["FlowPose", "MotionOnly"])
def test_k5_plain_on_packed_arguments_equals_the_eager_rounds(frame_one_refinements, name):
    """Every entry of the rounds' final state (active rows, carried and
    result blocks, the global, error, counters, flags) equals the plain
    rounds' bit for bit: through the wrapper on the CPU, through the plain
    version on the arguments `pack` lays out, and through `unpack` of the
    outputs laid out as the kernel writes them."""
    kind, P, valid, start = frame_one_refinements[name]
    want = refine.rounds_plain(kind, P, refine.rounds_start(kind, valid, start))
    assert _equal(refine.run_rounds(kind, P, refine.rounds_start(kind, valid, start)), want)
    kid, fparams, iparams, packed = refine.pack(kind, P, refine.rounds_start(kind, valid, start))
    got = refine.unpack(kind, k5_on_the_cpu(kid, fparams, iparams, *packed))
    assert got.keys() == want.keys()
    for key in want:
        assert _equal(got[key], want[key]), key
    assert _equal(refine.unpack(kind, _as_outputs(kind, want)), want)
    assert valid.shape[0] >= 2 and bool(want["active"].any())
    assert packed[0].shape[-1] == (8 if name == "FlowPose" else 4) and all(t.is_contiguous() for t in packed)


def _pnp_problem(rng, n=160):
    cam = JCam.create(200.0, 200.0, 160.0, 120.0, 320, 240)
    w = rng.normal(0, 0.05, 3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + K + 0.5 * K @ K
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    t = rng.normal(0, 0.2, 3)
    uv = rng.uniform([10, 10], [310, 230], (n, 2))
    z = rng.uniform(4, 12, n)
    p_cam = np.stack([(uv[:, 0] - 160) / 200 * z, (uv[:, 1] - 120) / 200 * z, z], -1)
    uv_obs = uv + rng.normal(0, 0.3, uv.shape)
    bad = rng.random(n) < 0.2
    uv_obs[bad] += rng.uniform(-30, 30, (bad.sum(), 2))
    f = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    return cam, f(p_cam @ R.T + t)[None], f(uv_obs)[None], f(p_cam)[None], torch.as_tensor(rng.random(n) > 0.15)[None]


@pytest.mark.parametrize("mode", ["3d2d_score_cap", "3d3d"])
def test_k6_plain_on_packed_arguments_equals_the_eager_ransac(rng, mode):
    """`ransac_rigid` on the CPU against its draw and compaction, then K6's
    plain version on the arguments `pack` lays out for the kernel, then the
    scatter: pose, inliers, count and status bit for bit; K6's wrapper on
    the CPU gives the same.  The hypotheses are JAX's draw over the
    (compacted) valid rows."""
    jcam, p_w, uv, p_cam, valid = _pnp_problem(rng)
    cap = 96 if mode == "3d2d_score_cap" else None
    v = valid
    if cap is not None:
        order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices[:, :cap]
        v = torch.gather(valid, 1, order)
    idx = torch.as_tensor(np.asarray(jran.sample_valid_indices(jax.random.PRNGKey(7), jnp.asarray(v[0].numpy()),
                                                               200, 3)).astype(np.int64))[None]
    if mode == "3d3d":
        src, dst, uv_k, cam = p_cam, p_w, None, None
        want = tran.ransac_rigid(src, dst, valid, iters=200, threshold=0.1, idx=idx)
    else:
        src, dst, uv_k, cam = p_w, p_cam, uv, convert.camera_from_numpy(jcam._asdict())
        want = tran.ransac_pose_3d2d(p_w, uv, p_cam, valid, cam, iters=200, threshold_px=2.0, min_inliers=10,
                                     score_cap=cap, idx=idx)
    threshold, min_inliers = (0.1, 5) if mode == "3d3d" else (2.0, 10)
    s, d, u, vv = src, dst, uv_k, valid
    if cap is not None:
        gather = lambda x: torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))  # noqa: E731
        s, d, u, vv = gather(src), gather(dst), gather(uv_k), v
    r = tran.hypotheses_and_polish_plain(*ransac_kernel.pack(s, d, vv, idx, u), cam, threshold, 5, min_inliers)
    inl = r.inliers if cap is None else torch.zeros_like(valid).scatter(1, order, r.inliers)
    assert _equal((r.pose, inl, r.n_inliers, r.status), (want.pose, want.inliers, want.n_inliers, want.status))
    assert _equal(tran.hypotheses_and_polish(s, d, vv, idx, u, cam, threshold, 5, min_inliers), r)
    assert int(r.status[0]) == tran.STATUS_VALID


class Replay:
    def __init__(self, fn):
        self.replay = fn


def fake_capture(variants, device, warmups=2):
    return {name: Replay(fn) for name, fn in variants.items()}


def test_the_fused_schedule_equals_the_host_loops_bit_for_bit(golden, monkeypatch):
    """Four golden frames, the step as the card schedules it (tracking, the
    `eigh`, the rest) with every K5 and K6 call routed through the
    kernels' argument layouts and outputs (`k5_on_the_cpu`, K6's plain
    version on `pack`'s arguments), eager and over fixed buffers replayed
    as captured (the capture replaced by eager replays), against the CPU's
    step: packets, states and the generator bit for bit; a steady frame is
    the stretches track, eigh and rest, two of them replays."""
    cam, cfg, frames = golden
    monkeypatch.setattr(graphs, "capture", fake_capture)
    monkeypatch.setattr(fe, "_FRAME_GRAPHS", type(fe._FRAME_GRAPHS)())
    real_rounds, real_k6 = refine.run_rounds, tran.hypotheses_and_polish
    routed = {"K5": 0, "K6": 0}

    def rounds_as_on_the_card(kind, P, R0):
        routed["K5"] += 1
        kid, fparams, iparams, tensors = refine.pack(kind, P, R0)
        return refine.unpack(kind, k5_on_the_cpu(kid, fparams, iparams, *tensors))

    def k6_as_on_the_card(src, dst, valid, idx, uv, cam_, threshold, refine_steps, min_inliers):
        routed["K6"] += 1
        return tran.hypotheses_and_polish_plain(*ransac_kernel.pack(src, dst, valid, idx, uv), cam_, threshold,
                                                refine_steps, min_inliers)

    gens = [torch.Generator().manual_seed(0) for _ in range(3)]
    states = [_state(cfg)] * 3
    for k, f in enumerate(frames):
        prev, first = frames[max(k - 1, 0)], k == 0
        outs = []
        for i in range(3):
            c = fe._step_settings(cam, cfg.frontend, True, first, gens[i])
            inputs = dict(state=states[i], prev=prev, images=f,
                          u=fe._draw_uniforms(states[i], cfg.frontend, first, gens[i], CPU))
            card = i > 0
            monkeypatch.setattr(refine, "run_rounds", rounds_as_on_the_card if card else real_rounds)
            monkeypatch.setattr(tran, "hypotheses_and_polish", k6_as_on_the_card if card else real_k6)
            if i == 2 and not first:
                before = graphs.counts("frontend")["replays"]
                outs.append(fe._captured_step(inputs, c).step(inputs))
                assert graphs.counts("frontend")["replays"] - before == 2
            else:
                outs.append(fe._run_eagerly({"in": inputs}, c)["out"])
        assert _equal(tuple(outs[1]), tuple(outs[0])) and _equal(tuple(outs[2]), tuple(outs[0])), k
        states = [o[0] for o in outs]
    assert all(torch.equal(g.get_state(), gens[0].get_state()) for g in gens)
    assert routed["K5"] >= 2 * 3 and routed["K6"] >= 2 * 4
    c = fe._step_settings(cam, cfg.frontend, True, False, gens[0])
    names = []
    fe._schedule(names.append, c)
    assert names == ["track", "eigh", "rest"] and set(fe._variants(c)) == set(names)
