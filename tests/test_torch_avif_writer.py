"""The port's AVIF writer (ignis_tpu_torch/utils/av1_enc.py, av1_fwd.py,
the encoder's side of av1.py, yuv.rgb_to_yuv420 and avif.heif_image)
against OpenCV, through which ignis_tpu writes .avif files (cv2 5.0.0 with
libavif 1.4.2 and libaom), and Pillow (libavif 1.3.0).

The symbol encoder is held to the decoder's round trip, the headers to
av1.Decoder's reading and to cv2's own bytes, the forward transforms to
the normative inverses, the RGB to YUV conversion to Pillow's lossless
planes, and the files to three readers: cv2, Pillow and the port's
decoder read each to the same pixels, and the port's decoder to exactly
the encoder's reconstruction. On the small in-repo sources of cv2's
default files, the port's file keeps base_q_idx 148, a PSNR within 0.5 dB
of cv2's and an AV1 payload within twice cv2's."""
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import av1, av1_enc, av1_fwd, av1_recon, avif
from ignis_tpu_torch.utils import av1_tables as T
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils import yuv

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
sys.path.insert(0, str(ROOT / "scripts"))
from make_image_fixtures import rgb8  # noqa: E402

SIZES = [(1, 1), (5, 7), (24, 33), (37, 45), (3, 65)]


def _noise(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(
        np.uint8)


def _cv2_avif(rgb) -> bytes:
    ok, buf = cv2.imencode(".avif", np.ascontiguousarray(rgb[..., ::-1]))
    assert ok
    return buf.tobytes()


def _cv2_read(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return np.ascontiguousarray(img[..., ::-1])


def _psnr(a, b):
    return float(10 * np.log10(255.0 ** 2 / np.mean(
        (a.astype(np.float64) - b) ** 2)))


# ---- symbol coding ------------------------------------------------------
@pytest.mark.parametrize("update", [True, False])
def test_symbol_encoder_round_trip(update):
    """Symbols of random 2- to 16-symbol CDFs (skewed and uniform), bools,
    literals and ns values, written by SymbolEncoder with CDF adaptation
    on or off, decode to the same values and leave the same CDFs; the
    counter's bits come within 1% (and 16 bits) of the bytes."""
    rng = np.random.default_rng(int(update) + 10)
    tables = []
    for _ in range(12):
        n = int(rng.integers(2, 17))
        cuts = np.sort(rng.choice(np.arange(1, 32768), n - 1, replace=False))
        tables.append(cuts.tolist() + [32768, 0])
    seq = []
    for _ in range(4000):
        kind = rng.random()
        if kind < 0.1:
            seq.append(("literal", int(rng.integers(1, 9)), None))
        elif kind < 0.15:
            seq.append(("ns", int(rng.integers(2, 40)), None))
        else:
            t = int(rng.integers(0, len(tables)))
            n = len(tables[t]) - 1
            s = int(min(rng.geometric(0.4) - 1, n - 1)) if rng.random() < \
                0.7 else int(rng.integers(0, n))
            seq.append(("symbol", t, s))
    values = []
    for kind, a, s in seq:
        if kind == "literal":
            values.append(int(rng.integers(0, 1 << a)))
        elif kind == "ns":
            values.append(int(rng.integers(0, a)))
        else:
            values.append(s)
    enc = av1.SymbolEncoder(not update)
    count = av1.SymbolCounter()
    enc_tables = [list(t) for t in tables]
    cnt_tables = [list(t) for t in tables]
    for (kind, a, _), v in zip(seq, values):
        if kind == "symbol":
            # the counter prices each symbol against the encoder's CDFs
            cnt_tables[a][:] = enc_tables[a]
            count.symbol(cnt_tables[a], v)
            enc.symbol(enc_tables[a], v)
        else:
            getattr(count, kind)(a, v)
            getattr(enc, kind)(a, v)
    data = enc.done()
    sd = av1.SymbolDecoder(data, 0, len(data), not update)
    dec_tables = [list(t) for t in tables]
    got = []
    for kind, a, _ in seq:
        if kind == "symbol":
            got.append(sd.symbol(dec_tables[a]))
        else:
            got.append(getattr(sd, kind)(a))
    assert got == values
    assert dec_tables == enc_tables
    assert abs(8 * len(data) - count.bits) <= max(16, 0.01 * count.bits)


def test_leb128_round_trip():
    for v in (0, 1, 127, 128, 300, 16383, 16384, 2 ** 31):
        b = av1.leb128_bytes(v)
        assert av1.leb128(b + b"\0", 0) == (v, len(b))


# ---- headers -------------------------------------------------------------
@pytest.mark.parametrize("w,h", [(1, 1), (33, 24), (500, 300), (1024, 1024),
                                 (4096, 40)])
def test_headers_read_back(w, h):
    """Every field the writer sets reads back through av1.Decoder's header
    parse: the size, level, colour description and tools of the sequence
    header; the quantiser, delta q, deblocking, CDEF and tx mode of the
    frame header, with one tile up to 4,032 pixels a row and two at
    4,096 (libaom's layout, test_tile_layout_equals_cv2s)."""
    seq = av1_enc.sequence_header(w, h)
    for lf, cy, cuv, dq in (((15, 15, 15, 15), (2, 1), (0, 0), 1),
                            ((0, 0, 0, 0), (0, 0), (3, 4), 0),
                            ((63, 40, 7, 1), (15, 4), (15, 2), 1)):
        hdr = av1_enc.frame_header(w, h, lf, cy, cuv, dq)
        d = av1_enc.frame_state(seq, hdr)
        s = d.seq
        assert (s["max_w"], s["max_h"], s["reduced"], s["profile"]) == \
            (w, h, 1, 0)
        assert (s["cp"], s["tc"], s["mc"], s["full_range"]) == (1, 13, 6, 1)
        assert (s["bd"], s["mono"], s["ssx"], s["ssy"]) == (8, 0, 1, 1)
        assert (s["sb128"], s["filter_intra"], s["edge_filter"], s["cdef"],
                s["restoration"], s["film_grain"], s["superres"]) == \
            (0, 1, 1, 1, 0, 0, 0)
        assert (d.w, d.h, d.disable_cdf_update, d.sct) == (w, h, 0, 0)
        assert (d.base_q, d.dq, d.using_qm, d.qm) == (
            148, [[0, 0], [-16, -16], [-16, -16]], 1, [8, 8, 8])
        assert (d.delta_q_present, d.delta_q_res, d.delta_lf_present) == \
            ((1, 2, 0) if dq else (0, 0, 0))
        want_lf = list(lf) if lf[0] or lf[1] else [0, 0, 0, 0]
        assert (d.lf_level, d.lf_sharp, d.lf_delta_enabled) == \
            (want_lf, 1, 1)
        assert (d.cdef_damping, d.cdef_bits, d.cdef_y, d.cdef_uv) == \
            (5, 0, [cy], [cuv])
        assert d.lr_type == [0, 0, 0] and d.grain is None
        assert (d.tx_mode_select, d.reduced_tx_set) == (0, 0)
        assert (len(d.col_starts), len(d.row_starts)) == (
            (3, 2) if w == 4096 else (2, 2))
        assert not d.seg_enabled and not d.coded_lossless


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (3, 65), (24, 33),
                                 (240, 320), (512, 512), (130, 70), (37, 45),
                                 (16, 4160)])
def test_headers_equal_cv2s(h, w):
    """Given cv2's own choices (deblocking, CDEF, delta q, and with tiles
    the tile named for the context update and the bytes of a tile size),
    the sequence header OBU and the frame header are cv2's bytes, the
    level and the tile layout included (on images where cv2 codes each
    block's largest transform, as the writer does); the container of
    cv2's AV1 item is cv2's file byte for byte."""
    data = _cv2_avif(_noise(h, w, h * w) if h != 37 else rgb8(h, w, 30))
    item = avif.parse_avif(data)["av1"]
    d = av1.Decoder(item)
    assert d.tx_mode_select == 0
    seq = av1_enc._obu(1, av1_enc.sequence_header(w, h))
    assert seq in item
    hdr = av1_enc.frame_header(w, h, d.lf_level, d.cdef_y[0], d.cdef_uv[0],
                               d.delta_q_present, d.context_update_tile_id,
                               d.tile_size_bytes)
    at = item.index(b"\x32", item.index(seq) + len(seq))
    size, p = av1.leb128(item, at + 1)
    assert item[p:p + len(hdr)] == hdr
    assert avif.heif_image(item, seq, w, h) == data


# ---- transforms -------------------------------------------------------------
def _valid_types(tx):
    h, w = av1.TXH[tx], av1.TXW[tx]
    out = []
    for t in range(16):
        vk, hk = av1_recon.TX_KINDS[t]
        if all(not (k in (1, 2) and n > 16) and not (k == 3 and n > 32)
               for k, n in ((vk, h), (hk, w))):
            out.append(t)
    return out


@pytest.mark.parametrize("tx", range(19))
def test_forward_inverse_round_trip(tx):
    """Every transform type of every size: the forward transform, then the
    normative inverse, gives the residual back within 2 levels (random
    residuals; for 64-point sizes, whose coefficients past 32 are zero,
    smooth ones, within 3); the floating-point inverse of the search stays
    within 2 levels of the normative one."""
    rng = np.random.default_rng(tx)
    h, w = av1.TXH[tx], av1.TXW[tx]
    for t in _valid_types(tx):
        if max(h, w) == 64:
            yy, xx = np.mgrid[0:h, 0:w]
            x = (100 * np.sin(xx / 9.0 + rng.random((8, 1, 1)))
                 * np.cos(yy / 11.0)).astype(np.int64)
        else:
            x = rng.integers(-255, 256, (8, h, w))
        c = av1_fwd.forward_transform(x, tx, t)
        back = av1_recon.inverse_transform(c, tx, t, False, 8)
        assert np.abs(back - x).max() <= (3 if max(h, w) == 64 else 2), \
            (tx, t)
        est = av1_fwd.inverse_estimate(c, tx, t)
        assert np.abs(est - back).max() <= 2, (tx, t)


def test_quantiser_matches_the_decoders_dequantiser():
    """dequantize of the encoder's levels is what av1_recon.residuals
    dequantises from the same levels (qm level 8, both plane kinds, small
    and large transforms)."""
    rng = np.random.default_rng(3)
    for tx in (0, 1, 2, 3, 4, 9):
        for plane in (0, 1):
            q = av1_fwd.quantizers(tx, plane, 120, (-16, -16) if plane
                                   else (0, 0), 8, 0)
            coef = rng.integers(-4000, 4001, (1, av1.TXH[tx], av1.TXW[tx]))
            lev = av1_fwd.quantize(coef, tx, q)[0]
            deq = av1_fwd.dequantize(lev[None], tx, q)
            dcq = T.DC_Q[0][120 + (-16 if plane else 0)]
            acq = T.AC_Q[0][120 + (-16 if plane else 0)]
            out = {i: int(v) for i, v in enumerate(lev.reshape(-1)) if v}
            res = av1_recon.residuals([(0, out, dcq, acq, 8)], [plane], tx,
                                      False, 8)
            want = av1_recon.inverse_transform(deq, tx, 0, False, 8)
            np.testing.assert_array_equal(res, want)


# ---- colour -----------------------------------------------------------------
@pytest.mark.parametrize("h,w", SIZES + [(64, 64)])
def test_forward_yuv_matches_pillow(h, w):
    """libyuv's RGB to J420 (full-range BT.601, rounded 2 x 2 chroma
    averages) gives exactly the planes of Pillow's lossless 4:2:0 AVIF
    (libavif 1.3.0: base_q_idx 0, nclx 1/13/6 full range), odd sizes
    included."""
    img = _noise(h, w, 7 * h + w)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "AVIF", quality=100, subsampling="4:2:0")
    info = avif.parse_avif(bio.getvalue())
    assert info["nclx"] == (1, 13, 6, 1)
    assert av1.Decoder(info["av1"]).base_q == 0
    planes = av1.decode_av1(info["av1"]).planes
    for mine, theirs in zip(yuv.rgb_to_yuv420(img), planes):
        np.testing.assert_array_equal(mine, theirs)


# ---- files -----------------------------------------------------------------
@pytest.mark.parametrize("h,w", SIZES)
def test_files_read_back_by_every_reader(tmp_path, h, w):
    """save_image(.avif) of a smooth image with noise: cv2.imdecode and
    Pillow read the file to exactly the port decoder's pixels, and the
    port's decoder reads the AV1 item to exactly the encoder's own
    reconstruction; the header keeps base_q_idx 148 and no block is
    lossless."""
    src = rgb8(h, w, h + 3 * w)
    lin = imagelib.srgb_to_linear(src / np.float32(255.0)).astype(np.float32)
    path = tmp_path / "x.avif"
    imagelib.save_image(path, lin)
    data = path.read_bytes()
    port = avif.decode_avif(data)
    assert port.shape == (h, w, 3) and port.dtype == np.uint8
    np.testing.assert_array_equal(_cv2_read(data), port)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(pil, port)
    enc = av1_enc.encode_yuv420(*yuv.rgb_to_yuv420(src))
    assert avif.parse_avif(data)["av1"] == enc.obus
    for got, want in zip(av1.decode_av1(enc.obus).planes, enc.planes):
        np.testing.assert_array_equal(got, want)
    d = av1.Decoder(enc.obus)
    assert d.base_q == 148 and not any(d.lossless)
    assert all(r[4].qindex >= av1_enc.MIN_Q for r in d.records)


def _table_sources():
    px = np.load(DATA / "images" / "cv2_pixels.npz")
    return {"cv2_lossless.webp": px["cv2_lossless.webp"],
            "cv2_q80.webp": px["cv2_q80.webp"],
            "rgb8(37, 45, 30)": rgb8(37, 45, 30)}


@pytest.mark.parametrize("name", ["cv2_lossless.webp", "cv2_q80.webp",
                                  "rgb8(37, 45, 30)"])
def test_bars_against_ignis_tpu(tmp_path, name):
    """The same linear image through ignis_tpu's save_image (cv2.imwrite,
    no parameters) and the port's: the port's file has cv2's base_q_idx
    (148), a PSNR of at least cv2's less 0.5 dB and an AV1 payload of at
    most twice cv2's, and tests/data/avif_bars.json holds cv2's figures."""
    src = _table_sources()[name]
    lin = imagelib.srgb_to_linear(src / np.float32(255.0)).astype(np.float32)
    theirs, mine = tmp_path / "cv2.avif", tmp_path / "port.avif"
    jax_image.save_image(theirs, lin)
    imagelib.save_image(mine, lin)
    a, b = theirs.read_bytes(), mine.read_bytes()
    pa, pb = avif.parse_avif(a)["av1"], avif.parse_avif(b)["av1"]
    qa, qb = av1.Decoder(pa).base_q, av1.Decoder(pb).base_q
    psnr_a, psnr_b = _psnr(_cv2_read(a), src), _psnr(_cv2_read(b), src)
    assert qa == qb == 148
    assert psnr_b >= psnr_a - 0.5, (psnr_b, psnr_a)
    assert len(pb) <= 2 * len(pa), (len(pb), len(pa))
    bars = json.loads((DATA / "avif_bars.json").read_text())[name]
    assert bars["base_q_idx"] == qa
    assert bars["payload_bytes"] == len(pa)
    assert abs(bars["psnr_db"] - psnr_a) < 1e-9


def test_writer_has_no_fallback():
    """The encoder's modules import neither OpenCV nor Pillow, write only
    base_q_idx 148 and refuse what is not 8-bit RGB rather than write
    something else; past 4,096 pixels a row, where AV1 needs two tile
    columns, the header codes them (test_tiled_file_meets_cv2s_bars
    writes such a file) rather than refusing the image."""
    for mod in (av1_enc, av1_fwd, avif, yuv):
        text = Path(mod.__file__).read_text()
        assert "import cv2" not in text and "import PIL" not in text
        assert "from PIL" not in text
    with pytest.raises(ValueError):
        avif.encode_avif(np.zeros((4, 4), np.uint8))
    seq = av1_enc.sequence_header(4100, 8)
    d = av1_enc.frame_state(seq, av1_enc.frame_header(
        4100, 8, (0, 0, 0, 0), (0, 0), (0, 0)))
    assert (d.tile_cols_log2, d.tile_rows_log2) == (1, 0)
    assert d.col_starts == [0, 528, 1026]
    assert av1_enc.BASE_Q == 148


# ---- tiles -----------------------------------------------------------------
# (h, w) of frames past one tile: 4,096 pixels a row (libaom's extra
# column), wider, and above 9,437,184 pixels (AV1's area limit: 2,304
# superblocks a tile)
TILED = [(40, 4032), (40, 4096), (8, 4100), (16, 4160), (8, 8192),
         (8, 12300), (2, 16384), (4352, 2240), (2400, 4096)]


@pytest.mark.parametrize("h,w", TILED)
def test_tile_layout_equals_cv2s(h, w):
    """The writer's uniform tile layout is that of cv2's file of the same
    size (libaom's: AV1's least, with one more column where the
    superblock columns are exactly 64 x 2^k), read back from the frame
    header it writes, with no NotImplementedError: above 9,437,184 pixels
    too (4352 x 2240 takes AV1's least, two tile rows; 2400 x 4096 takes
    two tile columns, as libaom lays it out)."""
    src = np.zeros((h, w, 3), np.uint8)
    src[:, ::7] = 200
    item = avif.parse_avif(_cv2_avif(src))["av1"]
    theirs = av1.Decoder.__new__(av1.Decoder)
    theirs.name, theirs.seq, theirs.frame_done = "", None, False
    pos, seq, frame = 0, None, None
    while pos < len(item):
        kind = (item[pos] >> 3) & 15
        size, p = av1.leb128(item, pos + 1)
        if kind == 1:
            seq = item[p:p + size]
        elif kind == 6:
            frame = item[p:p + size]
        pos = p + size
    theirs.sequence_header(av1.BitReader(seq))
    theirs.frame_header(av1.BitReader(frame))
    want = (theirs.tile_cols_log2, theirs.tile_rows_log2)
    assert av1_enc.tile_layout(w, h) == want
    d = av1_enc.frame_state(av1_enc.sequence_header(w, h),
                            av1_enc.frame_header(w, h, (0, 0, 0, 0), (0, 0),
                                                 (0, 0)))
    assert (d.tile_cols_log2, d.tile_rows_log2) == want
    assert d.col_starts == theirs.col_starts
    assert d.row_starts == theirs.row_starts


def test_tile_group_sizes_as_libaom_writes_them():
    """More than one tile: a zero tile_start_and_end_present_flag byte,
    each tile but the last led by its size less one in the fewest bytes
    its largest needs, and the index of the (first) largest tile; one
    tile: its bytes alone."""
    tiles = [b"a" * 300, b"b" * 256, b"c" * 300, b"d" * 7]
    body, size_bytes, largest = av1_enc.tile_group(tiles)
    assert (size_bytes, largest) == (2, 0)
    assert body == (b"\0" + (299).to_bytes(2, "little") + tiles[0]
                    + (255).to_bytes(2, "little") + tiles[1]
                    + (299).to_bytes(2, "little") + tiles[2] + tiles[3])
    assert av1_enc.tile_group([b"x" * 255, b"y" * 9])[1:] == (1, 0)
    assert av1_enc.tile_group([b"z"]) == (b"z", 4, 0)


def test_tiled_file_meets_cv2s_bars(tmp_path):
    """save_image(.avif) of a 4,160 x 16 image (chip_smoke's wide source):
    two tile columns, as cv2's file of it has; cv2 reads the file to the
    port decoder's pixels and the decoder reads the AV1 item to the
    encoder's reconstruction; it keeps cv2's bars (base_q_idx 148, a PSNR
    of at least cv2's less 0.5 dB, an AV1 payload of at most twice
    cv2's), and tests/data/avif_bars.json holds cv2's figures."""
    import chip_smoke
    src = chip_smoke.wide_source()
    assert src.shape == (16, 4160, 3)
    lin = imagelib.srgb_to_linear(src / np.float32(255.0)).astype(np.float32)
    theirs, mine = tmp_path / "cv2.avif", tmp_path / "port.avif"
    jax_image.save_image(theirs, lin)
    imagelib.save_image(mine, lin)
    a, b = theirs.read_bytes(), mine.read_bytes()
    port = avif.decode_avif(b)
    np.testing.assert_array_equal(_cv2_read(b), port)
    pa, pb = avif.parse_avif(a)["av1"], avif.parse_avif(b)["av1"]
    da, db = av1.Decoder(pa), av1.Decoder(pb)
    assert (db.tile_cols_log2, db.tile_rows_log2) == (
        da.tile_cols_log2, da.tile_rows_log2) == (1, 0)
    enc = av1_enc.encode_yuv420(*yuv.rgb_to_yuv420(src))
    assert enc.obus == pb
    for got, want in zip(av1.decode_av1(pb).planes, enc.planes):
        np.testing.assert_array_equal(got, want)
    psnr_a, psnr_b = _psnr(_cv2_read(a), src), _psnr(port, src)
    assert da.base_q == db.base_q == 148
    assert psnr_b >= psnr_a - 0.5, (psnr_b, psnr_a)
    assert len(pb) <= 2 * len(pa), (len(pb), len(pa))
    bars = json.loads((DATA / "avif_bars.json").read_text())[
        chip_smoke.WIDE_AVIF]
    assert bars["payload_bytes"] == len(pa)
    assert (bars["tile_cols_log2"], bars["tile_rows_log2"]) == (1, 0)
    assert abs(bars["psnr_db"] - psnr_a) < 1e-9
    ok, what, psnr, payload = chip_smoke.avif_against_bars(
        mine, src, chip_smoke.WIDE_AVIF)
    assert ok, what
