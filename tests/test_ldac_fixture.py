"""FITS_LDAC binary-catalog bytes driven through the real parser path.

Without this fixture the SExtractor-subprocess catalog path would only be
stub-tested. No `sex` binary exists in this image and the sandbox has no
egress, so a catalog literally written by SExtractor cannot be obtained;
this fixture is the next-strongest evidence: the catalog bytes are
hand-assembled here card-by-card / struct-by-struct to the FITS_LDAC layout
SExtractor emits (primary HDU; LDAC_IMHEAD BINTABLE whose single
'Field Header Card' column carries the image header as an (80, N) char
array; LDAC_OBJECTS BINTABLE with big-endian 1J/1E/1D/1I columns and an
array-valued aperture column) — independently of sfft_jax.io.fits' own
writer, so the parser is exercised against foreign bytes, not its own
round-trip. Reference consumer: sfft/utils/pyAstroMatic/PYSEx.py:636-700.
"""

import numpy as np
import pytest

from sfft_jax.io import fits
from sfft_jax.prep.sex import parse_ldac_catalog

BLOCK = 2880


def _card(key, value=None, comment=None, string=False):
    """One 80-byte FITS header card, formatted the fixed way cfitsio does."""
    if value is None and comment is None:
        return key.ljust(80)[:80].encode("ascii")
    if string:
        v = "'" + str(value).ljust(8) + "'"
        body = f"{key:<8}= {v:<20}"
    elif isinstance(value, bool):
        body = f"{key:<8}= {'T' if value else 'F':>20}"
    else:
        body = f"{key:<8}= {value:>20}"
    if comment:
        body += f" / {comment}"
    return body.ljust(80)[:80].encode("ascii")


def _pad(b):
    return b + b"\x00" * ((-len(b)) % BLOCK)


def _hdrblock(cards):
    raw = b"".join(cards) + _card("END")
    return raw + b" " * ((-len(raw)) % BLOCK)


def make_ldac_bytes():
    """Assemble the full FITS_LDAC byte stream + the expected column values."""
    # --- primary HDU: no data, as SExtractor writes it
    primary = _hdrblock([
        _card("SIMPLE", True, "file does conform to FITS standard"),
        _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True),
    ])

    # --- LDAC_IMHEAD: the measured image's header as one row of one
    # '(80, n)' char-array column named 'Field Header Card'
    imcards = [
        _card("SIMPLE", True), _card("BITPIX", -32),
        _card("NAXIS", 2), _card("NAXIS1", 256), _card("NAXIS2", 256),
        _card("GAIN", "1.53", ), _card("SEXVERS", "2.25.0", string=True),
        _card("END"),
    ]
    blob = b"".join(imcards)
    nch = len(blob)
    imhead_hdr = _hdrblock([
        _card("XTENSION", "BINTABLE", string=True),
        _card("BITPIX", 8), _card("NAXIS", 2),
        _card("NAXIS1", nch), _card("NAXIS2", 1),
        _card("PCOUNT", 0), _card("GCOUNT", 1), _card("TFIELDS", 1),
        _card("TTYPE1", "Field Header Card", string=True),
        _card("TFORM1", f"{nch}A", string=True),
        _card("TDIM1", f"(80,{nch // 80})", string=True),
        _card("EXTNAME", "LDAC_IMHEAD", string=True),
    ])
    imhead = imhead_hdr + _pad(blob)

    # --- LDAC_OBJECTS: 6 detections, mixed big-endian column types
    number = np.array([1, 2, 3, 4, 5, 6], ">i4")                 # 1J
    x_img = np.array([10.5, 100.25, 128.0, 200.75, 3.0, 250.5], ">f4")  # 1E
    y_img = np.array([12.0, 90.5, 130.25, 180.0, 128.0, 254.0], ">f4")
    flux = np.array([1500.0, -3.5, 820.0, 4.2e4, 95.0, 410.0], ">f4")
    fluxerr = np.array([12.0, 8.0, 9.5, 105.0, 7.7, 9.9], ">f4")
    mag = np.array([20.07, 21.0, 20.71, 16.44, 23.05, 21.47], ">f4")
    alpha = np.array([150.1234, 150.2, 150.3, 150.4, 150.5, 150.6], ">f8")  # 1D
    flags = np.array([0, 0, 2, 3, 0, 16], ">i2")                 # 1I
    mag_aper = np.vstack([mag + 0.1, mag + 0.3, mag + 0.6]).T.astype(">f4")  # 3E

    cols = [
        ("NUMBER", "1J", number), ("X_IMAGE", "1E", x_img),
        ("Y_IMAGE", "1E", y_img), ("FLUX_AUTO", "1E", flux),
        ("FLUXERR_AUTO", "1E", fluxerr), ("MAG_AUTO", "1E", mag),
        ("ALPHA_J2000", "1D", alpha), ("FLAGS", "1I", flags),
        ("MAG_APER", "3E", mag_aper),
    ]
    nrows = len(number)
    rowbytes = [np.ascontiguousarray(a).view(np.uint8).reshape(nrows, -1)
                for _, _, a in cols]
    body = np.concatenate(rowbytes, axis=1).tobytes()
    rowlen = sum(p.shape[1] for p in rowbytes)

    cards = [
        _card("XTENSION", "BINTABLE", string=True),
        _card("BITPIX", 8), _card("NAXIS", 2),
        _card("NAXIS1", rowlen), _card("NAXIS2", nrows),
        _card("PCOUNT", 0), _card("GCOUNT", 1),
        _card("TFIELDS", len(cols)),
        _card("EXTNAME", "LDAC_OBJECTS", string=True),
    ]
    for k, (name, tform, _) in enumerate(cols, start=1):
        cards.append(_card(f"TTYPE{k}", name, string=True))
        cards.append(_card(f"TFORM{k}", tform, string=True))
    cards.append(_card("TDIM9", "(3)", string=True))
    objects = _hdrblock(cards) + _pad(body)

    expected = {name: a for name, _, a in cols}
    return primary + imhead + objects, expected


@pytest.fixture()
def ldac_file(tmp_path):
    raw, expected = make_ldac_bytes()
    path = tmp_path / "sex_cat.ldac.fits"
    path.write_bytes(raw)
    return str(path), expected


def test_read_ldac_parses_foreign_bytes(ldac_file):
    path, expected = ldac_file
    cols, imhdr = fits.read_ldac(path)
    # image header recovered from the Field Header Card blob
    assert int(imhdr["NAXIS1"]) == 256
    assert str(imhdr["SEXVERS"]).strip() == "2.25.0"
    # every column parsed with exact values, native order
    for name, want in expected.items():
        got = np.asarray(cols[name])
        np.testing.assert_array_equal(
            got.astype(np.float64), np.asarray(want, np.float64),
            err_msg=name)
    assert np.asarray(cols["FLAGS"]).dtype.kind == "i"
    assert np.asarray(cols["MAG_APER"]).shape == (6, 3)


def test_parse_ldac_catalog_reference_filters(ldac_file):
    path, _ = ldac_file
    # raw parse: all 6 rows, negative-flux row remagged to 99.0
    cat = parse_ldac_catalog(path)
    assert len(cat) == 6
    mags = np.asarray(cat["MAG_AUTO"])
    assert mags[1] == 99.0
    np.testing.assert_allclose(mags[[0, 2]], [20.07, 20.71], rtol=1e-6)

    # FLAGS whitelist (reference ONLY_FLAGS=[0]) keeps rows 1, 2, 5
    cat_f = parse_ldac_catalog(path, ONLY_FLAGS=[0])
    assert list(np.asarray(cat_f["NUMBER"])) == [1, 2, 5]

    # boundary rejection: XBoundary=YBoundary=4 on a 256^2 image drops the
    # x=3.0 source and the y=254.0 > 256-4+1 source
    cat_b = parse_ldac_catalog(path, XBoundary=4, YBoundary=4, N0=256, N1=256)
    assert list(np.asarray(cat_b["NUMBER"])) == [1, 2, 3, 4]

    # composed, as _run_binary applies them
    cat_fb = parse_ldac_catalog(path, ONLY_FLAGS=[0, 2], XBoundary=4,
                                YBoundary=4, N0=256, N1=256)
    assert list(np.asarray(cat_fb["NUMBER"])) == [1, 2, 3]
