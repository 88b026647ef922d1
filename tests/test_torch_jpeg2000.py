"""The port's JPEG 2000 codec (ignis_tpu_torch/utils/jpeg2000.py and
utils/ebcot.py) against OpenCV, through which ignis_tpu reads and writes
.jp2 files (cv2 5.0.0 with OpenJPEG 2.5.3).

Files from cv2's writer and from Pillow's (12.1.0, also OpenJPEG), with
every option Pillow has: the five progression orders, quality layers,
resolutions, code-block sizes, the reversible 5/3 and irreversible 9/7,
the colour transform on and off, tiles, precincts, grey, RGB and RGBA,
8 and 16 bits; each read by the port and by cv2.imdecode on the same
bytes. cv2 reads no file with an image offset, so those are held to
Pillow's own OpenJPEG decode. The MQ coder, tier-1 and both wavelets are
held to their round trips; save_image's .jp2 to ignis_tpu's file of the
same image, both read by cv2."""
import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import ebcot, jpeg2000
from ignis_tpu_torch.utils import image as imagelib

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
DATA = Path(__file__).resolve().parent / "data"
FIXTURES = DATA / "images"


def _cv2_rgb(data: bytes):
    """cv2.imdecode of data as [h, w, 3] RGB (grey replicated, alpha
    dropped), or None where cv2 reads nothing."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _photo(h, w, seed=0, noise=12.0):
    """uint8 [h, w, 3]: colour waves with noise and both ends of 0-255."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 110 * np.sin(xx / (5.0 + c) + c)
                    * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img = img + rng.normal(0, noise, img.shape)
    img[2:6, 3:12] = 255
    img[8:12, 20:26] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def _smooth(h, w):
    """A smooth uint8 [h, w, 3] image whose whole .jp2 stream fits cv2's
    rate of 4, so both writers keep it lossless."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([127 + 120 * np.sin(xx / (40.0 + 9 * c) + c)
                     * np.cos(yy / (55.0 - 7 * c)) for c in range(3)],
                    -1).astype(np.uint8)


def _pil(arr, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, "JPEG2000", **kw)
    return bio.getvalue()


# ---------------------------------------------------------------------------
# files of cv2 and Pillow, read as cv2 reads them
# ---------------------------------------------------------------------------

JP2_FIXTURES = sorted(p.name for p in FIXTURES.iterdir()
                      if p.suffix in (".jp2", ".j2k"))


@pytest.mark.parametrize("name", JP2_FIXTURES)
def test_jpeg2000_fixture_matches_cv2(name):
    """Each JPEG 2000 fixture (scripts/make_image_fixtures.py) decodes to
    cv2_pixels.npz exactly, the 9/7 one too, and cv2 still reads the
    same pixels."""
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2_rgb((FIXTURES / name).read_bytes()),
                                  want)


def test_jpeg2000_fixture_set():
    """The JPEG 2000 fixtures: cv2's default (cut by rate 4, its code
    stream within h * w * 3 / 4 bytes), lossless 16-bit and grey files,
    Pillow's 9/7 layered, tiled and RGBA files, and OpenJPEG's own
    (scripts/make_jp2_fixtures.py): every Part 1 code-block style, SOP,
    EPH, POC, RGN, PPM, PPT, palettes and sYCC; and the HTJ2K files of
    scripts/make_htj2k_fixtures.py (tests/test_torch_htj2k.py)."""
    assert JP2_FIXTURES == sorted([
        "cv2_default.jp2", "cv2_lossless_16bit.jp2", "cv2_grey.jp2",
        "pil_irreversible_layers.jp2", "pil_tiles_precincts.j2k",
        "pil_rgba_pcrl.jp2",
        "opj_style01.jp2", "opj_style02.jp2", "opj_style04.jp2",
        "opj_style08.jp2", "opj_style10.jp2", "opj_style20.jp2",
        "opj_style3f.jp2", "opj_bypass_termall_53.jp2",
        "opj_bypass_termall_97.jp2", "opj_sop.jp2", "opj_eph.jp2",
        "opj_sop_eph.jp2", "opj_poc.jp2", "opj_poc_tileparts.jp2",
        "opj_poc_cut.jp2",
        "opj_rgn_comp0.jp2", "opj_rgn_all.jp2",
        "opj_grey16_bypass_rgn.jp2", "opj_ppm.jp2", "opj_ppt.jp2",
        "opj_palette8.jp2", "opj_palette16_index.jp2",
        "opj_palette16_entries.jp2", "opj_sycc.jp2",
        "opj_texture_64.jp2"] + [
        "ht_grey8_53.j2k", "ht_rgb8_rct.jp2", "ht_rgb8_97.jp2",
        "ht_sigprop.j2k", "ht_magref.j2k", "ht_layers_opj.j2k",
        "ht_grey16.j2k", "ht_odd_tiles.jp2", "ht_sparse.j2k",
        "ht_vlc_all.j2k", "ht_texture_64.jp2", "ht_empty_refinement.j2k"])
    data = (FIXTURES / "cv2_default.jp2").read_bytes()
    src = np.load(FIXTURES / "cv2_pixels.npz")["cv2_default.jp2"]
    h, w = src.shape[:2]
    cs, _ = jpeg2000.codestream(data)
    assert len(cs) <= h * w * 3 // 4


PROGRESSION_KW = dict(precinct_size=(32, 32), codeblock_size=(16, 16),
                      quality_mode="rates", quality_layers=[30, 10])
VARIANTS = {
    **{f"progression_{p}": dict(progression=p, **PROGRESSION_KW)
       for p in jpeg2000.PROGRESSIONS},
    "layers_1": dict(quality_mode="rates", quality_layers=[12]),
    "layers_3": dict(quality_mode="rates", quality_layers=[40, 20, 8]),
    "resolutions_1": dict(num_resolutions=1),
    "resolutions_3": dict(num_resolutions=3),
    "resolutions_6": dict(num_resolutions=6),
    "codeblock_4x4": dict(codeblock_size=(4, 4), quality_mode="rates",
                          quality_layers=[6]),
    "codeblock_16x64": dict(codeblock_size=(16, 64)),
    "codeblock_64x64": dict(codeblock_size=(64, 64)),
    "reversible": dict(irreversible=False),
    "irreversible": dict(irreversible=True),
    "irreversible_layers": dict(irreversible=True, quality_mode="rates",
                                quality_layers=[30, 10, 4]),
    "mct_on": dict(mct=1, irreversible=True),
    "mct_off": dict(mct=0),
    "tiles": dict(tile_size=(32, 32), codeblock_size=(16, 16),
                  progression="RPCL"),
    "tiles_irreversible_raw": dict(no_jp2=True, tile_size=(24, 40),
                                   irreversible=True, num_resolutions=4,
                                   plt=True),
    "grey": dict(mode="L"),
    "rgba": dict(mode="RGBA", quality_mode="rates", quality_layers=[10]),
    "rgb_8bit": dict(mode="RGB"),
    "grey_16bit": dict(mode="I;16"),
    "grey_16bit_irreversible": dict(mode="I;16", irreversible=True,
                                    quality_mode="rates",
                                    quality_layers=[20]),
}


def _variant(case):
    kw = dict(VARIANTS[case])
    mode = kw.pop("mode", "RGB")
    img = _photo(36, 44, seed=len(case))
    if mode == "L":
        arr = img[..., 1]
    elif mode == "RGBA":
        arr = np.dstack([img, img[..., 0] // 2])
    elif mode == "I;16":
        arr = img[..., 1].astype(np.uint16) * 257 + np.random.default_rng(
            3).integers(0, 257, img.shape[:2]).astype(np.uint16)
    else:
        arr = img
    return _pil(arr, **kw)


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_pillow_variant_matches_cv2(case):
    """Pillow's JPEG 2000 with one option varied reads to exactly cv2's
    pixels (dtype included), the irreversible 9/7 ones too."""
    data = _variant(case)
    want = _cv2_rgb(data)
    got = jpeg2000.decode_jpeg2000(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tail,lanes", [(0, 2048), (1 << 20, 2048),
                                        (0, 5)])
@pytest.mark.parametrize("case", ["layers_3", "irreversible", "grey_16bit"])
def test_lockstep_and_scalar_decodes_match_cv2(monkeypatch, case, tail,
                                                lanes):
    """The same files with every code-block in the numpy lockstep (in
    one run, or in runs of 5 code-blocks), and with every code-block
    decoded in Python integers: each cv2's pixels."""
    monkeypatch.setattr(ebcot, "TAIL", tail)
    monkeypatch.setattr(jpeg2000, "LANES", lanes)
    data = _variant(case)
    np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data),
                                  _cv2_rgb(data))


def test_cv2_writer_variants_match_cv2():
    """cv2's own files: default (rate 4, lossy), lossless 8- and 16-bit
    colour and grey, read as cv2 reads them."""
    img = _photo(32, 34, 7)
    cases = [(img, []), (img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]),
             (img[..., 0], []),
             (img.astype(np.uint16) * 251,
              [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]),
             (img.astype(np.uint16) * 251, [])]
    for arr, params in cases:
        data = cv2.imencode(".jp2", arr, params)[1].tobytes()
        np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data),
                                      _cv2_rgb(data))


@pytest.mark.parametrize("kw", [
    dict(offset=(3, 1), tile_offset=(0, 0), tile_size=(64, 64)),
    dict(offset=(5, 6), tile_offset=(1, 2), tile_size=(20, 24),
         progression="PCRL", precinct_size=(32, 32), num_resolutions=4),
    dict(offset=(9, 7), tile_offset=(5, 3), tile_size=(16, 16)),
    dict(offset=(5, 6), tile_offset=(1, 2), tile_size=(20, 24),
         irreversible=True, progression="RPCL")], ids=str)
def test_image_and_tile_offsets_match_openjpeg(kw):
    """Image and tile offsets (odd canvas origins, so each wavelet level
    starts on odd samples): the components equal Pillow's OpenJPEG
    decode; decode_samples raises IOError as cv2 reads nothing."""
    img = _photo(37, 45, 5)
    data = _pil(img, **kw)
    comps, hd, _ = jpeg2000.decode_components(data)
    assert (hd.X0, hd.Y0) == kw["offset"]
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(np.stack(comps, -1), want)
    assert _cv2_rgb(data) is None
    with pytest.raises(IOError, match="offset"):
        jpeg2000.decode_jpeg2000(data)


@pytest.mark.parametrize("what", ["two_components", "signed", "precinct",
                                  "subsampling"])
def test_files_cv2_does_not_read_raise_ioerror(what):
    """A two-component (grey and alpha) file, a signed one, one with a
    2^0 precinct above resolution 0 (Pillow's precinct_size=(16, 16)) and
    cv2's own file with its second component's SIZ subsampling set to 2,
    which cv2 refuses: decode_jpeg2000 raises IOError, as ignis_tpu
    raises for cv2.imread's None."""
    img = _photo(33, 35, 9)
    if what == "subsampling":
        data = bytearray(cv2.imencode(".jp2", _photo(32, 32, 1))[1].tobytes())
        cs = data.index(b"\xff\x4f\xff\x51")
        data[cs + 4 + 38 + 1] = 2
        data = bytes(data)
    elif what == "signed":
        data = _pil(img[..., 0], signed=True)
    elif what == "precinct":
        data = _pil(img, precinct_size=(16, 16))
    else:
        bio = io.BytesIO()
        Image.fromarray(np.dstack([img[..., 0], img[..., 1]]), "LA").save(
            bio, "JPEG2000")
        data = bio.getvalue()
    assert _cv2_rgb(data) is None
    with pytest.raises(IOError, match="Cannot load image"):
        jpeg2000.decode_jpeg2000(data)


# ---------------------------------------------------------------------------
# the MQ coder, tier-1 and the wavelets
# ---------------------------------------------------------------------------

def test_mq_coder_round_trip():
    """Random decisions in random contexts (skewed per context) encoded
    by the lanes' MQ encoder decode back, lane by lane, including a lane
    with no decisions and the byte counts at pass marks."""
    rng = np.random.default_rng(4)
    n, T = 5, 3000
    ctx = rng.integers(0, 19, (n, T))
    p = rng.random(19)
    sym = (rng.random((n, T)) < p[ctx]).astype(np.int64)
    lengths = [T, 2000, 1, 0, 1234]
    for i, m in enumerate(lengths):
        ctx[i, m:] = -1
    marks = np.array([[min(m, k) for k in (1, 500, 1500)] for m in lengths])
    streams, at = ebcot.mq_encode(ctx, sym, marks)
    assert np.all(np.diff(at, axis=1) >= 0)
    assert all(at[i, -1] <= len(s) for i, s in enumerate(streams))
    dec = ebcot._MQDecoder([[s] for s in streams])
    lanes = dec.lanes(np.arange(n))
    for t in range(T):
        on = ctx[:, t] >= 0
        got = lanes.code(np.maximum(ctx[:, t], 0), on)
        np.testing.assert_array_equal(got[on], sym[on, t])


@pytest.mark.parametrize("tail", [0, 4, 1 << 20])
def test_tier1_round_trip_and_truncation(monkeypatch, tail):
    """Code-blocks of every band orientation and odd shapes (1 x 9 to
    64 x 16) through every pass decode to their coefficients; truncated
    at OpenJPEG's pass lengths they decode to the encoder's own
    reconstruction (its squared error per pass). All lanes in lockstep
    (tail 0), all in Python integers, and handed over mid-pass."""
    monkeypatch.setattr(ebcot, "TAIL", tail)
    rng = np.random.default_rng(1)
    shapes = [(4, 4), (16, 16), (7, 13), (32, 32), (3, 5), (64, 16),
              (1, 9), (9, 1), (24, 40)]
    coeffs = []
    for i, (h, w) in enumerate(shapes):
        c = rng.laplace(0, 2.0 ** (i % 3), (h, w)).astype(np.int64)
        c[rng.random((h, w)) < 0.3] = 0
        coeffs.append(c)
    planes = [int(np.abs(c).max()).bit_length() for c in coeffs]
    orient = [i % 4 for i in range(len(shapes))]
    passes = [3 * p - 2 for p in planes]
    enc = ebcot.CodeBlocks(shapes, orient, planes, passes)
    streams, rates = enc.encode(coeffs)
    dec = ebcot.CodeBlocks(shapes, orient, planes, passes).decode(
        [[(s, p)] for s, p in zip(streams, passes)])
    for i, c in enumerate(coeffs):
        v = dec.block(i)
        np.testing.assert_array_equal(np.sign(v) * (np.abs(v) >> 1), c)
    for k in (1, 2, 6):
        ps = [min(k, p) for p in passes]
        cut = [s[:r[q - 1]] for s, r, q in zip(streams, rates, ps)]
        d = ebcot.CodeBlocks(shapes, orient, planes, ps).decode(
            [[(s, p)] for s, p in zip(cut, ps)])
        for i, c in enumerate(coeffs):
            err = ((np.abs(c) - (np.abs(d.block(i)) >> 1)) ** 2).sum()
            assert err == enc.dist[i, ps[i]], (k, i)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 33])
def test_53_round_trip(n):
    """The forward and inverse reversible 5/3 of the writer and reader
    undo each other exactly along either axis."""
    x = np.random.default_rng(n).integers(-300, 300, (n, 5))
    for axis in (0, 1):
        y = jpeg2000._fdwt53_1d(x, axis)
        np.testing.assert_array_equal(
            jpeg2000._idwt53_1d(y, 0, axis), x)


def _fdwt97(x, cas):
    """A float64 forward 9/7 in OpenJPEG's conventions (lifting alpha,
    beta, gamma, delta; low times 1 / K, high times K / 2), the inverse
    of what the reader's _idwt97_1d does."""
    x = x.astype(np.float64).copy()
    n = len(x)
    i = np.arange(n)
    lo, hi = i[cas::2], i[1 - cas::2]
    m = jpeg2000._mirror
    for step, c in enumerate((-1.586134342, -0.052980118, 0.882911075,
                              0.443506852)):
        t = hi if step % 2 == 0 else lo
        x[t] = x[t] + (x[m(t - 1, n)] + x[m(t + 1, n)]) * c
    x[lo] /= 1.230174105
    x[hi] /= 1.625732422
    return x


@pytest.mark.parametrize("n,cas", [(2, 0), (2, 1), (5, 0), (5, 1), (8, 0),
                                   (9, 1), (64, 0)])
def test_97_round_trip(n, cas):
    """The reader's float32 inverse 9/7 undoes a float64 forward 9/7 of
    either start parity within float32 rounding."""
    x = np.random.default_rng(n + cas).normal(0, 50, n)
    y = _fdwt97(x, cas).astype(np.float32)
    back = jpeg2000._idwt97_1d(y[:, None], cas, 0)[:, 0]
    np.testing.assert_allclose(back, x, atol=1e-3)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _psnr(a, ref):
    mse = np.mean((a.astype(np.float64) - ref) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("shape,kind", [((40, 52), "photo"),
                                        ((48, 48), "noise"),
                                        ((48, 64), "smooth")])
def test_save_image_jp2_against_jax(tmp_path, shape, kind):
    """save_image and ignis_tpu's save_image (cv2.imwrite) of one float
    image as .jp2, both read by cv2: the port's code stream is within
    cv2's byte budget (h * w * 3 / 4), its PSNR against the 8-bit source
    at least cv2's less 0.5 dB (lossless where cv2's is), and the port
    reads its own file exactly as cv2 does."""
    h, w = shape
    rgb = {"photo": _photo(h, w, 2, noise=20.0),
           "noise": np.random.default_rng(5).integers(0, 256, (h, w, 3),
                                                      dtype=np.uint8),
           "smooth": _smooth(h, w)}[kind]
    lin = imagelib.srgb_to_linear(rgb / np.float32(255.0)).astype(np.float32)
    ldr = (imagelib.linear_to_srgb(lin) * 255.0 + 0.5).astype(np.uint8)
    imagelib.save_image(tmp_path / "p.jp2", lin)
    jax_image.save_image(str(tmp_path / "j.jp2"), lin)
    data = (tmp_path / "p.jp2").read_bytes()
    ours = _cv2_rgb(data)
    theirs = _cv2_rgb((tmp_path / "j.jp2").read_bytes())
    cs, space = jpeg2000.codestream(data)
    assert space == 16 and len(cs) <= h * w * 3 // 4
    assert _psnr(ours, ldr) >= _psnr(theirs, ldr) - 0.5
    if kind == "smooth":
        np.testing.assert_array_equal(theirs, ldr)
        np.testing.assert_array_equal(ours, ldr)
    np.testing.assert_array_equal(imagelib.decode_samples(tmp_path / "p.jp2"),
                                  ours)


def test_writer_psnr_bar_of_chip_smoke():
    """tests/data/jp2_psnr.json holds the PSNR of cv2's .jp2 of
    cv2_q80.webp's pixels (chip_smoke's bar for the port's writer, less
    0.5 dB); cv2 still gives it, and the port's file of those pixels
    meets the bar."""
    src = np.load(FIXTURES / "cv2_pixels.npz")["cv2_q80.webp"]
    bar = json.loads((DATA / "jp2_psnr.json").read_text())["cv2_q80.webp"]
    data = cv2.imencode(".jp2", np.ascontiguousarray(src[..., ::-1]))[1]
    assert _psnr(_cv2_rgb(data.tobytes()), src) == pytest.approx(bar)
    ours = jpeg2000.decode_jpeg2000(jpeg2000.encode_jp2(src))
    assert _psnr(ours, src) >= bar - 0.5


def test_writer_in_runs_of_few_code_blocks_writes_the_same_file(
        monkeypatch):
    """Encoding the code-blocks 5 at a time gives the bytes of one run."""
    src = _photo(40, 52, 6)
    whole = jpeg2000.encode_jp2(src)
    monkeypatch.setattr(jpeg2000, "LANES", 5)
    assert jpeg2000.encode_jp2(src) == whole


@pytest.mark.parametrize("shape", [(31, 40), (40, 31), (27, 35)])
def test_save_image_jp2_below_32_pixels_raises(tmp_path, shape):
    """Below 32 pixels a side save_image raises ValueError naming '.jp2'
    and the minimum, where ignis_tpu's cv2.imwrite returns False and
    leaves a 77-byte file that cv2 cannot read."""
    img = np.random.default_rng(3).random(shape + (3,)).astype(np.float32)
    with pytest.raises(ValueError, match="'.jp2' needs at least 32"):
        imagelib.save_image(tmp_path / "p.jp2", img)
    assert not (tmp_path / "p.jp2").exists()
    jax_image.save_image(str(tmp_path / "j.jp2"), img)
    data = (tmp_path / "j.jp2").read_bytes()
    assert len(data) == 77
    assert _cv2_rgb(data) is None


# ---------------------------------------------------------------------------
# load_image against ignis_tpu
# ---------------------------------------------------------------------------

def test_load_image_jp2_matches_jax_png(tmp_path):
    """The port's load_image of cv2's default .jp2 equals ignis_tpu's
    load_image of the same pixels (as cv2 reads them) written as PNG,
    sRGB-decoded and linear."""
    img = _photo(36, 40, 8)
    p = tmp_path / "t.jp2"
    assert cv2.imwrite(str(p), img)
    png = tmp_path / "t.png"
    assert cv2.imwrite(str(png), cv2.imread(str(p), FLAGS))
    for lin in (False, True):
        got = imagelib.load_image(p, linear=lin)
        want = jax_image.load_image(str(png), linear=lin)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.xfail(strict=True, reason="ignis_tpu's load_image returns a "
                   ".jp2's raw 0-255 integers as linear radiance (it scales "
                   "only .png, .jpg, .jpeg, .bmp and .tga; a reference fault "
                   "the port fixes, ROADMAP queue 3)")
def test_unscaled_8bit_jp2_of_jax_reference(tmp_path):
    """The port's load_image of cv2's lossless .jp2 against ignis_tpu's:
    they differ by the reference's missing 1/255 (and sRGB decode)."""
    p = tmp_path / "t.jp2"
    assert cv2.imwrite(str(p), _photo(33, 34, 12),
                       [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    for lin in (False, True):
        np.testing.assert_allclose(imagelib.load_image(p, linear=lin),
                                   jax_image.load_image(str(p), linear=lin),
                                   rtol=1e-6)
