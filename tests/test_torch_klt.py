"""Port parity for the sampling and LK layer (`ops/klt.py`) and the plain
versions of kernels K1 (LK level) and K2 (point sampler).

On the CPU the K1/K2 wrappers run their plain versions, so these tests hold
the plain versions against the JAX package: the Pallas kernels in
interpret mode, and the XLA forms `klt_track` / `bilinear_sample` /
`nearest_at`.  Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynosam_tpu.ops import klt as jklt
from dynosam_tpu.ops.pallas.lk import klt_track_pallas
from dynosam_tpu.ops.pallas.point_sample import point_sample as j_point_sample
from dynosam_tpu.testing.render import RenderConfig, RenderedScene
from dynosam_tpu_torch import kernels
from dynosam_tpu_torch.kernels.lk import lk_level_plain
from dynosam_tpu_torch.kernels.point_sample import point_sample, point_sample_plain
from dynosam_tpu_torch.ops import klt as tklt

torch.set_num_threads(2)

T = lambda a, dt=np.float32: torch.as_tensor(np.array(np.asarray(a), dt))

# The JAX references, each under one `jax.jit` as the JAX frontend runs them
# (called eagerly, every primitive compiles on its own)
_point_sample = jax.jit(j_point_sample, static_argnums=(2,), static_argnames=("interpret",))
_bilinear_sample = jax.jit(jklt.bilinear_sample)
_nearest_at = jax.jit(jklt.nearest_at)
_flow_at = jax.jit(jklt.flow_at)
_build_pyramid = jax.jit(jklt.build_pyramid, static_argnums=(1,))
_klt_track = jax.jit(jklt.klt_track, static_argnames=("win", "levels", "iters"))
_klt_track_pallas = jax.jit(klt_track_pallas, static_argnames=("win", "levels", "iters", "eps", "interpret"))


@pytest.fixture(scope="module")
def frames():
    f0, f1 = RenderedScene(RenderConfig(n_frames=2, h=192, w=256)).frames()
    return f0, f1


def _sample_inputs(rng, h=96, w=160):
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    mask = rng.integers(0, 9, (h, w)).astype(np.int32)
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    uv = np.concatenate([
        rng.uniform([0, 0], [w - 1, h - 1], (40, 2)),
        [[0.0, 0.0], [w - 1.0, h - 1.0], [-3.0, 5.0], [w + 4.0, h + 2.0],
         [2.25, h - 1.0], [7.5, 8.5], [6.5, 3.5]],      # half-way: rounds to even
    ]).astype(np.float32)
    return img, mask, flow, uv


def test_point_sample_plain_matches_pallas_interpret(rng):
    """K2 plain == the Pallas point sampler (interpret) for both modes,
    border-clamped coordinates and valid-row masking.  Bilinear agrees to
    float association order (rtol 1e-5, atol 1e-3 on [0, 255] values);
    nearest labels exactly (round half to even on both sides)."""
    img, mask, flow, uv = _sample_inputs(rng)
    valid = rng.uniform(size=uv.shape[0]) > 0.3
    stack = np.stack([img, mask.astype(np.float32), flow[..., 0], flow[..., 1]])
    modes = ("bilinear", "nearest", "bilinear", "bilinear")
    want = np.asarray(_point_sample(jnp.asarray(stack), jnp.asarray(uv), modes,
                                    valid=jnp.asarray(valid), interpret=True))
    got = point_sample_plain(T(stack), T(uv), modes, T(valid, bool)).numpy()
    np.testing.assert_allclose(got[:, [0, 2, 3]], want[:, [0, 2, 3]], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert np.all(got[~valid] == 0.0)


@pytest.mark.parametrize("case", ["typed_list", "flow_strided_views", "valid_none", "chw_tensor"])
def test_point_sample_plain_reads_channels_as_they_are(rng, case):
    """K2 plain on channels passed in place (float32, int32 and bool
    planes; the strided planes of an (H, W, 2) flow; `valid=None`; a
    (C, H, W) tensor) == the stacked float32 form bit for bit, and == the
    Pallas point sampler (interpret) on that stack: bilinear to rtol 1e-5 /
    atol 1e-3 on [0, 255] values (association order), nearest exactly."""
    img, mask, flow, uv = _sample_inputs(rng)
    valid = rng.uniform(size=uv.shape[0]) > 0.3
    tv = T(valid, bool)
    if case == "typed_list":
        chans = (T(img), T(mask, np.int32), T(mask > 4, bool), T(mask > 4, bool))
        modes = ("bilinear", "nearest", "nearest", "bilinear")
    elif case == "flow_strided_views":
        tf = T(flow)
        chans = (tf[..., 0], tf[..., 1])
        assert not chans[0].is_contiguous()
        modes = ("bilinear", "bilinear")
    elif case == "valid_none":
        chans = (T(img), T(mask, np.int32))
        modes = ("bilinear", "nearest")
        valid, tv = np.ones(uv.shape[0], bool), None
    else:
        chans = T(np.stack([img, flow[..., 0], mask.astype(np.float32)]))
        modes = ("bilinear", "bilinear", "nearest")
    got = point_sample(chans, T(uv), modes, tv)
    assert got.dtype == torch.float32 and got.shape == (uv.shape[0], len(modes))
    stacked = torch.stack([ch.float() for ch in chans])
    assert torch.equal(got, point_sample_plain(stacked, T(uv), modes, tv))
    want = np.asarray(_point_sample(jnp.asarray(stacked.numpy()), jnp.asarray(uv), modes,
                                    valid=jnp.asarray(valid), interpret=True))
    for c, m in enumerate(modes):
        if m == "nearest":
            np.testing.assert_array_equal(got[:, c].numpy(), want[:, c])
        else:
            np.testing.assert_allclose(got[:, c].numpy(), want[:, c], rtol=1e-5, atol=1e-3)
    assert np.all(got.numpy()[~valid] == 0.0)


def test_point_queries_match_xla(rng):
    """`bilinear_sample`, `nearest_at`, `flow_at` and `sample_channels` of
    the port == the JAX package's XLA forms (rtol 1e-5 / exact labels)."""
    img, mask, flow, uv = _sample_inputs(rng)
    valid = rng.uniform(size=uv.shape[0]) > 0.4
    jb = np.asarray(_bilinear_sample(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(valid)))
    tb = tklt.bilinear_sample(T(img), T(uv), T(valid, bool)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-3)
    jn = np.asarray(_nearest_at(jnp.asarray(mask), jnp.asarray(uv)))
    tn = tklt.nearest_at(T(mask, np.int32), T(uv)).numpy()
    np.testing.assert_array_equal(tn, jn)
    assert tn.dtype == np.int32
    jf = np.asarray(_flow_at(jnp.asarray(flow), jnp.asarray(uv), jnp.asarray(valid)))
    tf = tklt.flow_at(T(flow), T(uv), T(valid, bool)).numpy()
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-4)
    d, lab = tklt.sample_channels((T(img), T(mask, np.int32)), ("bilinear", "nearest"), T(uv))
    np.testing.assert_allclose(d.numpy(), np.asarray(_bilinear_sample(jnp.asarray(img), jnp.asarray(uv))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(lab.numpy(), jn)


def test_pyramid_matches_xla(rng):
    """Zero-padded 5x5 binomial blur and the 3-level pyramid (atol 1e-3 on
    [0, 255] values: 25-tap sums in another order)."""
    img = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    jp = _build_pyramid(jnp.asarray(img), 3)
    tp = tklt.build_pyramid(T(img), 3)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


def test_klt_track_matches_xla(frames, rng):
    """Port `klt_track` == JAX `klt_track` (3 levels x 30 iterations, cold
    start): < 0.05 px on features both accept, as `tests/test_pallas.py`
    holds the Pallas kernel to."""
    f0, f1 = frames
    uv = rng.uniform([5, 5], [250, 186], (64, 2)).astype(np.float32)
    valid = np.ones(64, bool)
    ref = _klt_track(f0.gray, f1.gray, jnp.asarray(uv), jnp.asarray(valid), win=21, levels=3, iters=30)
    got = tklt.klt_track(T(f0.gray), T(f1.gray), T(uv), T(valid, bool), win=21, levels=3, iters=30)
    both = np.asarray(ref.ok) & got.ok.numpy()
    assert both.sum() >= 40
    d = np.linalg.norm(np.asarray(ref.uv) - got.uv.numpy(), axis=1)
    assert d[both].max() < 0.05
    assert (np.asarray(ref.ok) == got.ok.numpy()).mean() > 0.9


@pytest.mark.parametrize("case", ["warm_mixed", "cold_3_levels"])
def test_lk_plain_matches_pallas_interpret(frames, rng, case):
    """K1 plain (through `klt_track_lk`, the tracker's entry) == the Pallas
    LK kernel in interpret mode with the same eps and valid mask: < 0.05 px
    on features both accept; inactive slots come back exactly uv + g0 and
    not ok; the photometric error agrees to 1e-2 grey levels."""
    f0, f1 = frames
    n = 48
    uv = rng.uniform([15, 15], [240, 176], (n, 2)).astype(np.float32)
    if case == "warm_mixed":
        valid = rng.random(n) > 0.3
        g0 = np.asarray(jklt.flow_at(f0.flow, jnp.asarray(uv))) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
        kw = dict(levels=1, iters=10, eps=0.01)
    else:
        valid = np.ones(n, bool)
        g0 = None
        kw = dict(levels=3, iters=30, eps=0.01)
    ref = _klt_track_pallas(
        f0.gray, f1.gray, jnp.asarray(uv), jnp.asarray(valid), win=21,
        g0=None if g0 is None else jnp.asarray(g0), interpret=True, **kw,
    )
    got = tklt.klt_track_lk(
        T(f0.gray), T(f1.gray), T(uv), T(valid, bool), win=21,
        g0=None if g0 is None else T(g0), **kw,
    )
    ok_r, ok_g = np.asarray(ref.ok), got.ok.numpy()
    both = ok_r & ok_g
    assert both.sum() >= 20
    d = np.linalg.norm(np.asarray(ref.uv) - got.uv.numpy(), axis=1)
    assert d[both].max() < 0.05
    np.testing.assert_allclose(got.error.numpy()[both], np.asarray(ref.error)[both], atol=1e-2)
    if g0 is not None:
        np.testing.assert_allclose(got.uv.numpy()[~valid], (uv + g0)[~valid], atol=1e-6)
    assert not ok_g[~valid].any()


def test_lk_plain_eps_freeze_is_per_slot(frames, rng):
    """A slot's result does not depend on its neighbours: tracking a slot
    alone gives the same flow as tracking it inside the batch (eps stop)."""
    f0, f1 = frames
    uv = rng.uniform([20, 20], [230, 170], (16, 2)).astype(np.float32)
    g0 = np.asarray(jklt.flow_at(f0.flow, jnp.asarray(uv)))
    valid = torch.ones(16, dtype=torch.bool)
    g_all, e_all = lk_level_plain(T(f0.gray), T(f1.gray), T(uv), T(g0), valid, 21, 10, 0.01)
    for i in (0, 7, 15):
        g1, e1 = lk_level_plain(T(f0.gray), T(f1.gray), T(uv[i:i + 1]), T(g0[i:i + 1]), valid[:1], 21, 10, 0.01)
        np.testing.assert_allclose(g1.numpy()[0], g_all.numpy()[i], atol=1e-5)


def test_wrappers_on_cpu_leave_launch_counts_at_zero(rng):
    """On CPU tensors every wrapper runs its plain version and counts no
    launch."""
    kernels.reset_launch_counts()
    img, mask, flow, uv = _sample_inputs(rng)
    point_sample(T(img)[None], T(uv), ("bilinear",))
    tklt.klt_track_lk(T(img), T(img), T(uv), torch.ones(uv.shape[0], dtype=torch.bool), levels=1, iters=2)
    from dynosam_tpu_torch.kernels.response import shi_tomasi_response

    shi_tomasi_response(T(img))
    from dynosam_tpu_torch.kernels.orb_sample import orb_orientation_descriptors

    orb_orientation_descriptors(T(img), T(img), T(uv))
    from dynosam_tpu_torch.core.camera import CameraParams
    from dynosam_tpu_torch.core.lie import se3_identity
    from dynosam_tpu_torch.frontend import refine
    from dynosam_tpu_torch.kernels import ransac, refine as refine_kernel
    from dynosam_tpu_torch.ops import ransac as ops_ransac

    pts = T(rng.normal(0, 2, (1, 40, 3)))
    args = (pts, pts + 0.5, torch.ones((1, 40), dtype=torch.bool), torch.randint(0, 40, (1, 20, 3)), None, None, 0.1)
    ops_ransac.hypotheses_and_polish(*args, 5, 5)
    kind = refine.FlowPose(CameraParams(100.0, 100.0, 80.0, 48.0), max_iterations=2, outlier_rounds=1)
    kp, flow0 = T(uv[None]), torch.ones((1, uv.shape[0], 2))
    P = refine.flow_pose_inputs(kind.cam, se3_identity((1,)), se3_identity(()), kp, torch.full(kp.shape[:2], 5.0),
                                flow0)
    R0 = refine.rounds_start(kind, torch.ones(kp.shape[:2], dtype=torch.bool), {"flow": flow0})
    refine.run_rounds(kind, P, R0)
    # the K5 and K6 bindings launch or raise: the CPU's plain versions are
    # the wrappers' choice, not theirs
    with pytest.raises(ValueError):
        ransac.ransac(*args)
    kid, fparams, iparams, tensors = refine.pack(kind, P, R0)
    with pytest.raises(ValueError):
        refine_kernel.rounds(kid, fparams, iparams, *tensors)
    assert kernels.launch_counts() == {"lk": 0, "point_sample": 0, "response": 0, "orb_sample": 0, "refine": 0,
                                       "ransac": 0, "window_build": 0, "window_step": 0, "window_update": 0}


@pytest.mark.parametrize("fn", ["tracker_state_from_numpy", "frontend_state_from_numpy"])
def test_state_hand_over_runs_on_the_card_unless_asked(fn):
    """`convert.*_from_numpy` put the state on the CUDA card by default and
    raise where there is none; `device="cpu"` keeps it on the CPU."""
    import jax

    from dynosam_tpu.frontend.frontend import FrontendState as JFrontendState
    from dynosam_tpu.frontend.tracker import TrackerState as JTrackerState
    from dynosam_tpu_torch import convert

    src = JTrackerState.create(64, 64, 4) if fn.startswith("tracker") else JFrontendState.create(64, 64, 4)
    src = jax.tree.map(np.asarray, src)
    st = getattr(convert, fn)(src, device="cpu")
    leaf = st.s_uv if fn.startswith("tracker") else st.tracker.s_uv
    assert leaf.device.type == "cpu"
    if torch.cuda.is_available():
        got = getattr(convert, fn)(src)
        leaf = got.s_uv if fn.startswith("tracker") else got.tracker.s_uv
        assert leaf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(convert, fn)(src)
