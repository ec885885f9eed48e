"""Port parity for `data/native_loader.py` (the port's ctypes binding of the
repository's `native/libdynoloader.so`) against the JAX package's binding
and cv2: the same decoded arrays, dtypes and shapes bit for bit (8/16-bit
gray and RGB), the same `png_info`, the prefetch pool, the error path, the
cv2 fallback when the library is missing, and the KITTI loader giving the
same frames through either decoder.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from test_data import make_fake_kitti  # noqa: E402

from dynosam_tpu.data import native_loader as jnl  # noqa: E402
from dynosam_tpu_torch.data import native_loader as tnl  # noqa: E402
from dynosam_tpu_torch.data.kitti import KittiDataset  # noqa: E402


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    out = {}
    for name, img in (("g8", rng.integers(0, 255, (40, 60), dtype=np.uint8)),
                      ("g16", rng.integers(0, 65535, (32, 48), dtype=np.uint16)),
                      ("c8", rng.integers(0, 255, (24, 36, 3), dtype=np.uint8)),
                      ("c16", rng.integers(0, 65535, (20, 30, 3), dtype=np.uint16))):
        p = str(d / f"{name}.png")
        cv2.imwrite(p, img)
        out[name] = p
    return out


def test_native_library_is_found():
    assert tnl.available() and jnl.available()
    assert tnl._find_lib() == jnl._find_lib()


def test_decode_and_info_match_jax_and_cv2(pngs):
    for name, p in pngs.items():
        got, want = tnl.decode_png(p), jnl.decode_png(p)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
        ref = cv2.imread(p, -1)
        np.testing.assert_array_equal(got, ref[..., ::-1] if ref.ndim == 3 else ref)
        assert tnl.png_info(p) == jnl.png_info(p)
    with pytest.raises(IOError):
        tnl.decode_png("/nonexistent/file.png")


def test_prefetch_pool(pngs):
    dec = tnl.PrefetchDecoder(n_threads=2)
    for p in pngs.values():
        dec.submit(p)
    for p in reversed(list(pngs.values())):
        np.testing.assert_array_equal(dec.get(p), jnl.decode_png(p))
    dec.close()


def test_cv2_fallback_and_kitti_frames(pngs, tmp_path, monkeypatch):
    root = make_fake_kitti(str(tmp_path / "k"))
    native = [KittiDataset(root).frame(k) for k in range(3)]
    monkeypatch.setattr(tnl, "_LIB", None)
    monkeypatch.setattr(tnl, "_find_lib", lambda: None)
    assert not tnl.available()
    np.testing.assert_array_equal(tnl.decode_png(pngs["c8"]), cv2.imread(pngs["c8"], -1))
    with pytest.raises(RuntimeError):
        tnl.PrefetchDecoder()
    for k, a in enumerate(native):
        b = KittiDataset(root).frame(k)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and bool((x == y).all())


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_layout_png_writer_decodes_as_cv2_does(tmp_path, dtype):
    """`testing/render.py:_write_png` (the KITTI-layout writer's PNGs,
    written without cv2) decodes to the same pixels through both decoders."""
    from dynosam_tpu_torch.testing.render import _write_png

    img = np.random.default_rng(1).integers(0, np.iinfo(dtype).max, (23, 37)).astype(dtype)
    p = str(tmp_path / "w.png")
    _write_png(p, img)
    for got in (tnl.decode_png(p), cv2.imread(p, -1)):
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
