"""WCS stack, resampling, scheduler-adjacent utilities."""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.io import fits
from sfft_jax.utils.wcs import (
    WCS, ReadWCS, CombineHeader, PatternRotationCalculator,
    NeighboringPixelCovariance,
)


def tan_header(crval=(150.0, 30.0), crpix=(100.5, 120.5), scale=0.0001,
               rot_deg=0.0, naxis=(200, 240)):
    hdr = fits.Header()
    th = np.deg2rad(rot_deg)
    cd = scale * np.array([[np.cos(th), -np.sin(th)],
                           [np.sin(th), np.cos(th)]])
    hdr.add("NAXIS1", naxis[0])
    hdr.add("NAXIS2", naxis[1])
    hdr.add("CTYPE1", "RA---TAN")
    hdr.add("CTYPE2", "DEC--TAN")
    hdr.add("CRVAL1", crval[0])
    hdr.add("CRVAL2", crval[1])
    hdr.add("CRPIX1", crpix[0])
    hdr.add("CRPIX2", crpix[1])
    hdr.add("CD1_1", cd[0, 0])
    hdr.add("CD1_2", cd[0, 1])
    hdr.add("CD2_1", cd[1, 0])
    hdr.add("CD2_2", cd[1, 1])
    return hdr


def test_wcs_roundtrip():
    w = WCS(tan_header(rot_deg=23.0))
    pix = np.array([[10.0, 20.0], [100.5, 120.5], [199.0, 3.0]])
    rd = w.all_pix2world(pix, 1)
    back = w.all_world2pix(rd, 1)
    np.testing.assert_allclose(back, pix, atol=1e-8)
    # CRPIX maps to CRVAL
    rd0 = w.all_pix2world(np.array([[100.5, 120.5]]), 1)[0]
    np.testing.assert_allclose(rd0, [150.0, 30.0], atol=1e-10)


def test_wcs_tpv_distortion_roundtrip():
    hdr = tan_header()
    hdr.add("CTYPE1", "RA---TPV")
    hdr.add("CTYPE2", "DEC--TPV")
    hdr.add("PV1_1", 1.0)
    hdr.add("PV1_4", 0.002)   # x^2 term
    hdr.add("PV2_1", 1.0)
    hdr.add("PV2_5", -0.001)  # x*y term
    w = WCS(hdr)
    pix = np.array([[30.0, 40.0], [150.0, 200.0]])
    rd = w.all_pix2world(pix, 1)
    back = w.all_world2pix(rd, 1)
    np.testing.assert_allclose(back, pix, atol=1e-6)


def test_pattern_rotation():
    h1 = tan_header(rot_deg=0.0)
    h2 = tan_header(rot_deg=35.0)
    # target grid rotated +35 deg => pattern must rotate -35 (i.e. +325 ccw)
    angle = PatternRotationCalculator.PRC(h1, h2)
    assert abs(((angle - 325.0 + 180) % 360) - 180) < 0.2


def test_combine_header():
    base = tan_header(crval=(10.0, 10.0))
    base.add("GAIN", 2.5)
    wcs2 = tan_header(crval=(99.0, -20.0))
    out = CombineHeader.CH(base, wcs2)
    assert out["CRVAL1"] == 99.0
    assert out["GAIN"] == 2.5


def test_neighboring_pixel_covariance(rng):
    white = rng.normal(0, 1, (200, 200))
    cov_w, level_w = NeighboringPixelCovariance.NPC(white)
    # correlated noise: smooth the field
    from scipy import ndimage
    corr = ndimage.gaussian_filter(white, 1.5)
    cov_c, level_c = NeighboringPixelCovariance.NPC(corr)
    assert level_c > 5 * max(level_w, 1e-3)


def test_pyswarp_resample_roundtrip(tmp_path, rng):
    from sfft_jax.prep.resample import PYSWarp

    # smooth image on a slightly rotated/shifted grid
    yy, xx = np.meshgrid(np.arange(240), np.arange(200), indexing="xy")
    img = 100 + 20 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
    h_obj = tan_header(rot_deg=3.0, crpix=(101.0, 122.0))
    h_ref = tan_header(rot_deg=0.0, crpix=(100.5, 120.5))
    fits.write(str(tmp_path / "obj.fits"), img, h_obj)
    fits.write(str(tmp_path / "ref.fits"), np.zeros_like(img), h_ref)
    out = PYSWarp.PS(str(tmp_path / "obj.fits"), str(tmp_path / "ref.fits"),
                     str(tmp_path / "resamp.fits"))
    # interior should be smooth, no NaN, values in range
    inner = out[40:-40, 40:-40]
    assert np.isfinite(inner).all()
    assert 60 < np.nanmean(inner) < 140
    # resampled through our own WCS consistency: resample back approximately
    out2 = PYSWarp.PS(str(tmp_path / "resamp.fits"), str(tmp_path / "obj.fits"),
                      str(tmp_path / "back.fits"))
    sel = np.isfinite(out2[60:-60, 60:-60])
    err = np.nanstd((out2[60:-60, 60:-60] - img[60:-60, 60:-60])[sel])
    assert err < 0.5


def test_image_zoom_rotate(rng):
    from sfft_jax.prep.resample import ImageZoomRotate

    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    psf = np.exp(-((xx - 31.5) ** 2 + (yy - 31.5) ** 2) / (2 * 3.0**2))
    rot = ImageZoomRotate.IZR(psf, PATTERN_ROTATE_ANGLE=360.0)
    np.testing.assert_allclose(rot, psf, atol=1e-6)
    # rotating a circular PSF changes nothing (up to interpolation)
    rot90 = ImageZoomRotate.IZR(psf, PATTERN_ROTATE_ANGLE=90.0)
    np.testing.assert_allclose(rot90, psf, atol=1e-3)
    # zoom conserves flux
    z = ImageZoomRotate.IZR(psf, ZOOM_SCAL_x=1.3, ZOOM_SCAL_y=1.3)
    assert abs(z.sum() - psf.sum()) / psf.sum() < 0.02


def test_pyswarp_binary_path_with_stub(tmp_path, monkeypatch):
    """Drive the swarp subprocess path end-to-end against a stub `swarp`
    executable that honours -dd, config patching, the .head target grid and
    weight-map output (reference PY_SWarp.PS semantics)."""
    import os
    import stat
    import sys

    from sfft_jax.io import fits as sfits

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(sfits.__file__))))
    stub = tmp_path / "swarp"
    stub.write_text(f"""#!{sys.executable}
import sys, os
sys.path.insert(0, {repr(repo_root)})
import numpy as np
from sfft_jax.io import fits
if "-dd" in sys.argv:
    print("IMAGEOUT_NAME coadd.fits")
    print("WEIGHTOUT_NAME coadd.weight.fits")
    print("RESAMPLING_TYPE LANCZOS3")
    print("SUBTRACT_BACK Y")
    raise SystemExit(0)
conf = sys.argv[sys.argv.index("-c") + 1]
kv = {{}}
for line in open(conf):
    parts = line.split()
    if len(parts) >= 2:
        kv[parts[0]] = parts[1]
assert kv["SUBTRACT_BACK"] == "N"
out_name = kv["IMAGEOUT_NAME"]
head = out_name[:-5] + ".head"
assert os.path.exists(head), "missing .head target grid"
htxt = open(head).read()
assert "NAXIS1" in htxt and "CRVAL1" in htxt
src = fits.getdata(sys.argv[1]).astype(np.float64)
wt = np.ones_like(src); wt[:2, :] = 0.0
hdr = fits.Header(); hdr.add("SATURATE", 12345.0)
fits.write(out_name, src + 1.0, hdr)
fits.write(kv["WEIGHTOUT_NAME"], wt)
""")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")

    img = 50.0 + np.arange(300.0).reshape(15, 20)
    h_obj = tan_header(rot_deg=2.0, crpix=(8.0, 8.0))
    h_obj.add("SATURATE", 60000.0)
    h_obj.add("GAIN", 2.0)
    h_ref = tan_header(rot_deg=0.0, crpix=(7.5, 7.5))
    fits.write(str(tmp_path / "obj.fits"), img, h_obj)
    fits.write(str(tmp_path / "ref.fits"), np.zeros_like(img), h_ref)

    from sfft_jax.prep.resample import PYSWarp
    out = PYSWarp.PS(str(tmp_path / "obj.fits"), str(tmp_path / "ref.fits"),
                     str(tmp_path / "resamp.fits"), FILL_VALUE=np.nan,
                     use_binary=True, VERBOSE_LEVEL=0)
    assert np.isnan(out[:2, :]).all()          # weight==0 filled
    assert np.allclose(out[2:], img[2:] + 1.0)  # stub's resample
    _, hdr_out = fits.read(str(tmp_path / "resamp.fits"))
    assert hdr_out["SWARP_O"] == "obj.fits"
    assert hdr_out["SATURATE"] == 12345.0      # swarp-updated satur level
    assert hdr_out["GAIN"] == 2.0              # base header preserved
    assert abs(hdr_out["CRPIX1"] - 7.5) < 1e-9  # ref WCS grid
