"""Minimal FITS I/O: round-trip and reading the reference-bundled data."""

import os

import numpy as np
import pytest

from sfft_jax.io import fits

NIRCAM = (
    "/root/reference/test/subtract_test_nircam/input_data/"
    "jw01324001001-01324-o001_t001_nircam_clear-f200w_i2d_stamp.fits"
)
DECORR = (
    "/root/reference/test/difference_noise_decorrelation/input_data/"
    "DEC-OBS04b.MatchKernel.fits"
)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int16, np.int32])
def test_roundtrip(tmp_path, dtype):
    rng = np.random.default_rng(3)
    if np.issubdtype(dtype, np.floating):
        data = rng.normal(0, 100, (13, 7)).astype(dtype)
    else:
        data = rng.integers(-1000, 1000, (13, 7)).astype(dtype)
    path = str(tmp_path / "x.fits")
    hdr = fits.Header()
    hdr.add("KERHW", 8, "MeLOn: SFFT")
    hdr.add("CONVD", "REF", "MeLOn: SFFT")
    hdr.add("GAIN", 1.5, "e-/ADU")
    fits.write(path, data, hdr)
    out, ohdr = fits.read(path)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, data)
    assert ohdr["KERHW"] == 8
    assert ohdr["CONVD"] == "REF"
    assert abs(ohdr["GAIN"] - 1.5) < 1e-12


@pytest.mark.skipif(not os.path.exists(NIRCAM), reason="reference data absent")
def test_read_reference_nircam():
    data, hdr = fits.read(NIRCAM)
    assert data.ndim == 2
    assert data.shape[0] > 100 and data.shape[1] > 100
    assert np.isfinite(data).any()


@pytest.mark.skipif(not os.path.exists(DECORR), reason="reference data absent")
def test_read_reference_kernel():
    data, hdr = fits.read(DECORR)
    assert data.ndim == 2
    # match kernels are small and roughly unit-sum
    assert max(data.shape) < 100
    assert 0.1 < np.nansum(data) < 10.0


FZ = ("/root/reference/test/subtract_test_crowded_flavor/TESS-Example/"
      "4check/sfft_diff4check.fits.fz")


@pytest.mark.skipif(not os.path.exists(FZ), reason="fz data absent")
def test_read_fpack_compressed():
    """RICE_1 + SUBTRACTIVE_DITHER_1 tile-compressed image (fpack)."""
    data, hdr = fits.read(FZ, ext=1)
    assert data.shape == (2048, 2048)
    import numpy as np

    finite = np.isfinite(data)
    assert finite.mean() > 0.9
    # a difference image: zero-centered, sane spread
    assert abs(np.nanmedian(data)) < 0.1
    assert 0.1 < np.nanstd(data) < 100.0


@pytest.mark.skipif(not os.path.exists(FZ), reason="fz data absent")
def test_rice_native_matches_python_fallback():
    from sfft_jax import native

    # grab the first compressed tile stream out of the real file
    raw = open(FZ, "rb").read()
    # header of HDU 1 starts at 2880; find table start
    pos = 2880
    end = False
    while not end:
        block = raw[pos : pos + 2880]
        pos += 2880
        for i in range(0, 2880, 80):
            if block[i : i + 3] == b"END":
                end = True
                break
    table_start = pos
    desc = np.frombuffer(raw[table_start : table_start + 8], dtype=">i4")
    nelem, hoff = int(desc[0]), int(desc[1])
    heap_start = table_start + 24 * 2048
    stream = raw[heap_start + hoff : heap_start + hoff + nelem]

    out_native = native.rice_decode(stream, 2048, 32)
    saved = native._native
    native._native = None
    try:
        out_py = native.rice_decode(stream, 2048, 32)
    finally:
        native._native = saved
    np.testing.assert_array_equal(out_native, out_py)


def test_bintable_ldac_roundtrip(tmp_path):
    cols = {
        "X_IMAGE": np.array([1.5, 2.5, 300.25]),
        "FLAGS": np.array([0, 2, 16], np.int16),
        "NAME": np.array(["a", "bc", "def"]),
        "VEC": np.arange(9.0).reshape(3, 3).astype(np.float32),
        "OK": np.array([True, False, True]),
        "NPIX": np.array([10, 20, 30], np.int32),
    }
    hdr = fits.Header()
    hdr.add("GAIN", 2.5, "e-/ADU")
    hdr.add("OBJECT", "M31")
    path = str(tmp_path / "cat.ldac")
    fits.write_ldac(path, cols, hdr)

    out, imh = fits.read_ldac(path)
    assert imh["GAIN"] == 2.5 and imh["OBJECT"] == "M31"
    for k, v in cols.items():
        got = out[k]
        if got.dtype.kind == "U":
            assert list(got) == list(v)
        else:
            assert np.array_equal(got, v), k
    # read_table by EXTNAME and by index agree
    t1, h1 = fits.read_table(path, extname="LDAC_OBJECTS")
    assert h1["EXTNAME"] == "LDAC_OBJECTS"
    assert np.array_equal(t1["X_IMAGE"], cols["X_IMAGE"])


def test_read_ldac_plain_bintable(tmp_path):
    # FITS_1.0-style catalog: single unnamed BINTABLE, no LDAC_IMHEAD
    cols = {"FLUX": np.array([5.0, 6.0])}
    path = str(tmp_path / "plain.fits")
    fits.write_table(path, cols, extname="CAT")
    out, imh = fits.read_ldac(path)
    assert np.array_equal(out["FLUX"], cols["FLUX"])
    assert len(imh) == 0


def test_pysex_binary_path_with_stub(tmp_path, monkeypatch):
    """Drive PYSEx._run_binary end-to-end against a stub `sex` executable
    that honours -dd / CATALOG_NAME / CHECKIMAGE_NAME and writes FITS_LDAC."""
    import stat
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(fits.__file__))))
    stub = tmp_path / "sex"
    stub.write_text(f"""#!{sys.executable}
import sys
sys.path.insert(0, {repr(repo_root)})
import numpy as np
from sfft_jax.io import fits
if "-dd" in sys.argv:
    print("CATALOG_NAME cat.fits")
    print("DETECT_THRESH 1.5")
    raise SystemExit(0)
conf = sys.argv[sys.argv.index("-c") + 1]
kv = {{}}
for line in open(conf):
    parts = line.split()
    if len(parts) >= 2:
        kv[parts[0]] = parts[1]
cols = {{"X_IMAGE": np.array([5.0, 9.0]), "Y_IMAGE": np.array([6.0, 2.0]),
        "FLUX_AUTO": np.array([100.0, -3.0]), "MAG_AUTO": np.array([20.0, 99.0]),
        "FLAGS": np.array([0, 0], np.int16)}}
hdr = fits.Header(); hdr.add("SEXVERS", "stub")
fits.write_ldac(kv["CATALOG_NAME"], cols, hdr)
if kv.get("CHECKIMAGE_TYPE", "NONE") != "NONE":
    for name in kv["CHECKIMAGE_NAME"].split(","):
        fits.write(name, np.zeros((4, 4), np.float32))
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")

    img = str(tmp_path / "img.fits")
    fits.write(img, np.random.default_rng(0).normal(size=(16, 16)))

    from sfft_jax.prep.sex import PYSEx
    cat, checks, _, _ = PYSEx.PS(
        FITS_obj=img, SExParam=["X_IMAGE", "Y_IMAGE", "FLUX_AUTO"],
        CHECKIMAGE_TYPE="SEGMENTATION", use_binary=True, VERBOSE_LEVEL=0)
    assert len(cat) == 2
    assert np.allclose(cat["X_IMAGE"], [5.0, 9.0])
    assert len(checks) == 1 and checks[0].shape == (4, 4)


def test_ldac_zero_rows(tmp_path):
    path = str(tmp_path / "empty.ldac")
    fits.write_ldac(path, {"X_IMAGE": np.array([], np.float64),
                           "FLAGS": np.array([], np.int16)})
    cols, _ = fits.read_ldac(path)
    assert cols["X_IMAGE"].shape == (0,) and cols["FLAGS"].shape == (0,)
