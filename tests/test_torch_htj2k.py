"""The port's HTJ2K reader (ITU-T T.814, JPEG 2000 Part 15:
ignis_tpu_torch/utils/htj2k.py and its wiring in utils/jpeg2000.py)
against OpenCV (cv2 5.0.0 with OpenJPEG 2.5.3), through which ignis_tpu
reads .jp2 and .j2k textures.

The fixtures are the files of the hand-written HT encoder
(scripts/htj2k_encoder.py, written by scripts/make_htj2k_fixtures.py):
in tests/data/images each decodes exactly to cv2_pixels.npz and to live
cv2.imdecode (dtype and shape included), each lossless one to its seeded
source; in tests/data/images_unread cv2 reads nothing of each and the
port raises IOError. The lockstep and the scalar block decoders agree,
the table walker's file reaches every CxtVLC codeword through the
port's decoder, and the bit-level parts (MEL, U-VLC, each stream's
unstuffing, SigProp and MagRef) are held to worked bit strings."""
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import htj2k, jpeg2000
from ignis_tpu_torch.utils import image as imagelib
from ignis_tpu_torch.utils.htj2k_tables import VLC0, VLC1

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import htj2k_encoder as H  # noqa: E402
import make_htj2k_fixtures as F  # noqa: E402

FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
DATA = Path(__file__).resolve().parent / "data"
FIXTURES = DATA / "images"
UNREAD = DATA / "images_unread"
HT = sorted(p.name for p in FIXTURES.glob("ht_*"))
HT_UNREAD = sorted(p.name for p in UNREAD.glob("ht_*"))


def _cv2_rgb(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def test_ht_fixture_sets():
    """The HT fixtures as scripts/make_htj2k_fixtures.py writes them: 13
    that cv2 reads, 6 that it reads nothing of."""
    assert HT == sorted(F.FIXTURES)
    assert HT_UNREAD == sorted(F.UNREAD_FIXTURES)


@pytest.mark.parametrize("name", HT)
def test_ht_fixture_matches_cv2(name):
    """Each HT fixture decodes to cv2_pixels.npz and to live cv2.imdecode
    of its bytes exactly, dtype and shape included."""
    data = (FIXTURES / name).read_bytes()
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    got = imagelib.decode_samples(FIXTURES / name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_cv2_rgb(data), want)


@pytest.mark.parametrize("name", sorted(F.SOURCES))
def test_lossless_fixture_is_its_source(name):
    """Each lossless HT fixture decodes, through the port, to the seeded
    source it was encoded from (cv2 does too: test_ht_fixture_matches_cv2
    and the fixtures script)."""
    src = np.asarray(F.SOURCES[name]())
    if src.ndim == 2:
        src = np.repeat(src[..., None], 3, -1)
    got = imagelib.decode_samples(FIXTURES / name)
    np.testing.assert_array_equal(got.astype(np.int64), src)


@pytest.mark.parametrize("name", HT)
def test_load_image_against_jax_reference(name):
    """The port's load_image of HT files against ignis_tpu's: ignis_tpu
    returns cv2's raw integers as they are, the port scales them to
    [0, 1] and sRGB-decodes unless `linear`."""
    p = FIXTURES / name
    raw = jax_image.load_image(str(p))
    top = np.float32(np.iinfo(imagelib.decode_samples(p).dtype).max)
    np.testing.assert_allclose(imagelib.load_image(p, linear=True) * top,
                               raw, rtol=1e-6)
    np.testing.assert_allclose(imagelib.load_image(p),
                               imagelib.srgb_to_linear(raw / top),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scalar,lanes", [(0, 2048), (1 << 20, 2048),
                                          (0, 5)])
@pytest.mark.parametrize("name", [
    "ht_odd_tiles.jp2", "ht_magref.j2k", "ht_sigprop.j2k", "ht_sparse.j2k",
    "ht_rgb8_97.jp2"])
def test_lockstep_and_scalar_decodes_match_cv2(monkeypatch, name, scalar,
                                                lanes):
    """Every HT code-block in the numpy lockstep (in one run, or in runs
    of 5), and every one a block at a time in Python integers: each
    cv2's pixels."""
    monkeypatch.setattr(htj2k, "SCALAR", scalar)
    monkeypatch.setattr(jpeg2000, "LANES", lanes)
    want = np.load(FIXTURES / "cv2_pixels.npz")[name]
    np.testing.assert_array_equal(
        jpeg2000.decode_jpeg2000((FIXTURES / name).read_bytes()), want)


@pytest.mark.parametrize("scalar", [0, 1 << 20])
def test_vlc_all_reaches_every_codeword(monkeypatch, scalar):
    """The port's decode of the table walker's file decodes every
    codeword of both CxtVLC tables (the initial quad row's and the
    rest's), in lockstep and a block at a time."""
    monkeypatch.setattr(htj2k, "SCALAR", scalar)
    monkeypatch.setattr(htj2k, "seen", set())
    imagelib.decode_samples(FIXTURES / "ht_vlc_all.j2k")
    assert htj2k.seen == {(0, i) for i in range(len(VLC0))} | \
        {(1, i) for i in range(len(VLC1))}


@pytest.mark.parametrize("name", HT_UNREAD)
def test_ht_files_cv2_reads_nothing_of_raise_ioerror(name):
    """Each HT file cv2 reads nothing of (more than 3 passes, RGN, mixed
    mode, a Scup past its segment, T.814's layer split that OpenJPEG's
    tier-2 misreads, an empty cleanup segment): the port raises IOError,
    as ignis_tpu's load_image raises for cv2.imread's None."""
    data = (UNREAD / name).read_bytes()
    assert _cv2_rgb(data) is None
    with pytest.raises(IOError, match="Cannot load image"):
        imagelib.load_image(UNREAD / name)
    with pytest.raises(IOError):
        jax_image.load_image(str(UNREAD / name))


def _cv2_codestream():
    """The code stream of cv2's own .jp2 of a small image."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    return bytearray(jpeg2000.codestream(
        cv2.imencode(".jp2", img)[1].tobytes())[0])


@pytest.mark.parametrize("what", ["CAP", "CPF", "Rsiz", "style40"])
def test_part15_marks_on_a_part1_file_read_as_cv2(what):
    """cv2's own Part 1 code stream with one Part 15 mark: a CAP or a CPF
    marker or the Rsiz bit leave it as it is (OpenJPEG reads by the
    code-block style alone); the HT style bit on MQ-coded blocks is read
    as cv2 reads it (pixels or IOError)."""
    data = _cv2_codestream()
    cs = data.index(b"\xff\x4f\xff\x51")
    if what == "Rsiz":
        data[cs + 6] |= 0x40
    elif what == "style40":
        data[data.index(b"\xff\x52", cs) + 12] |= 0x40
    else:
        at = cs + 4 + struct.unpack(">H", data[cs + 4:cs + 6])[0]
        body = struct.pack(">IH", 1 << 17, 0) if what == "CAP" else \
            struct.pack(">H", 0x4000)
        code = 0xFF50 if what == "CAP" else 0xFF59
        data[at:at] = struct.pack(">HH", code, 2 + len(body)) + body
    data = bytes(data)
    want = _cv2_rgb(data)
    if want is None:
        with pytest.raises(IOError, match="Cannot load image"):
            jpeg2000.decode_jpeg2000(data)
    else:
        np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data), want)


def test_cap_and_cpf_parse():
    """CAP's Pcap and Ccap15 fields, and CPF's words, as the header reads
    them from ht_texture_64.jp2 and from hand-made markers."""
    cs, _ = jpeg2000.codestream((FIXTURES / "ht_texture_64.jp2")
                                .read_bytes())
    hd = jpeg2000._Header(cs, "x")
    assert hd.cap["pcap"] == 1 << 17 and hd.cap["ccap"] == {15: 0}
    assert hd.cap["ht"]["set"] == "HTONLY" and hd.cap["ht"]["magb"] == 0
    assert hd.cpf == [0x4000]
    cap = jpeg2000.read_cap(struct.pack(">IHH", (1 << 31) | (1 << 17),
                                        0x1234, 0xE8A9))
    assert cap["ccap"] == {1: 0x1234, 15: 0xE8A9}
    assert cap["ht"] == {"set": "MIXED", "multi_ht": True, "rgn": False,
                         "heterogeneous": True, "irreversible": True,
                         "magb": 9}
    assert jpeg2000.read_cap(b"\0")["pcap"] is None


def test_openjpeg_layer_split():
    """OpenJPEG's HT tier-2: ht_layers_opj's blocks carry the cleanup in
    layer 0 and SigProp and MagRef in layer 1, and end with the cleanup's
    segment holding two passes (the second of no bytes) and the
    refinement segment one; ht_magref's, under termination on each pass,
    one pass and two."""
    for name, want in (("ht_layers_opj.j2k", [2, 1]),
                       ("ht_magref.j2k", [1, 2])):
        cs, _ = jpeg2000.codestream((FIXTURES / name).read_bytes())
        hd = jpeg2000._Header(cs, name)
        prog, layers, mct, codings, quants = hd.styles(0)
        comps = [jpeg2000._tile_component(0, 0, hd.X, hd.Y, cod)
                 for cod in codings]
        order = jpeg2000._packet_order(prog, layers, comps, 0, 0)
        jpeg2000._read_packets(b"".join(hd.tiles[0]["parts"]), order, comps,
                               quants, codings)
        blocks = [b for res in comps for rr in res for prc in
                  rr["precincts"] for part in prc for b in part[1]
                  if b.passes]
        assert blocks and layers == 2
        assert all([s[1] for s in b.segs] == want for b in blocks), name


# ---------------------------------------------------------------------------
# the bit-level parts, on worked bit strings
# ---------------------------------------------------------------------------

def test_mel_worked():
    """MEL from state 0: 1 1 1 (one zero event each: exponents 0), then
    0 1 (at exponent 1: one zero, then a one), 0 (a one at exponent 0),
    1 (a zero), 0 (a one) -- the byte 0xEA then 0xFF's ones."""
    mel = htj2k._Mel(htj2k.mel_bits(bytes([0b11101010])))
    assert [int(mel.event()) for _ in range(8)] == [0, 0, 0, 0, 1, 1, 0, 1]
    enc = H.MEL()
    for e in [0, 0, 0, 0, 1, 1, 0, 1]:
        enc.event(e)
    assert enc.finish() == bytes([0b11101010])


def test_mel_every_state_round_trip():
    """A long run of zero events takes MEL through states 0-12; random
    events after it decode back."""
    rng = np.random.default_rng(5)
    events = [0] * 300 + [1] + rng.integers(0, 2, 400).tolist()
    enc = H.MEL()
    for e in events:
        enc.event(e)
    assert enc.states == set(range(13))
    mel = htj2k._Mel(htj2k.mel_bits(enc.finish()))
    assert [int(mel.event()) for _ in events] == events


@pytest.mark.parametrize("vlc,mode,initial,want", [
    (0b1, 1, True, (2, 1, 1)),              # "1": u 1
    (0b10, 2, False, (1, 3, 2)),            # "01": u 2
    (0b1_100, 1, True, (5, 1, 4)),          # "001" + 1: u 4
    (0b10110_000, 2, True, (1, 28, 8)),     # "000" + 22: u 27
    (0b1_1_100, 3, True, (5, 3, 5)),        # initial, MEL 0, u0 > 2
    (0b1_10, 3, True, (3, 2, 3)),           # initial, MEL 0, "01" "1"
    (0b1_1, 4, True, (4, 4, 2)),            # initial, MEL 1: u - 2 each
    (0b1_1_100_10, 3, False, (3, 5, 6)),    # later rows: "01" "001" 1
])
def test_uvlc_worked(vlc, mode, initial, want):
    """U-VLC codes (prefix, then in pairs both prefixes before the
    suffixes; u includes kappa's 1): the scalar and lockstep readers."""
    assert htj2k._uvlc(vlc, mode, initial) == want
    got = htj2k._uvlc_lanes(np.array([vlc]), np.array([mode]), initial)
    assert tuple(int(g[0]) for g in got) == want


def test_forward_unstuffing_worked():
    """MagSgn / SigProp: LSB first, 7 bits after 0xFF, a 1 in the stuffed
    position ORed into the next bit, then the fill byte."""
    got = htj2k.forward_bits(bytes([0xFF, 0x7F, 0x02, 0xFF, 0x80]), 0)
    want = ([1] * 8 + [1] * 7 + [0, 1, 0, 0, 0, 0, 0, 0] + [1] * 8
            + [0] * 7 + [1] + [0] * 7)
    assert got.tolist() == want


def test_reverse_unstuffing_worked():
    """VLC: the upper nibble of the byte before Scup's (3 bits where its
    low three are 1), then bytes backward, 7 bits of a byte whose 7 low
    bits are 1 after one above 0x8F; MagRef starts as if after such a
    byte."""
    vlc = htj2k.reverse_bits(bytes([0x7F, 0xFF, 0x7F, 0x12]), True)
    assert vlc.tolist() == ([1, 1, 1] + [1] * 8 + [1] * 7
                            + [0, 1, 0, 0, 1, 0, 0, 0] + [0] * 8)
    mr = htj2k.reverse_bits(bytes([0x7F, 0x90, 0x7F]), False)
    assert mr.tolist() == ([1] * 7 + [0, 0, 0, 0, 1, 0, 0, 1] + [1] * 7
                           + [0] * 8)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stream_writers_invert_readers(seed):
    """The encoder's byte writers against the decoder's bit strings on
    random bits with long runs of 1s (stuffing on every stream)."""
    rng = np.random.default_rng(seed)
    bits = (rng.random(3000) < 0.93).astype(int).tolist()
    for fill in (0, 1):
        got = htj2k.forward_bits(H.pack_forward(bits, fill), 0xFF * fill)
        assert got[:len(bits)].tolist() == bits
    got = htj2k.reverse_bits(H.pack_backward(bits, False)[::-1], False)
    assert got[:len(bits)].tolist() == bits
    data = H.pack_backward(bits, True)
    got = htj2k.reverse_bits(data[::-1], True)
    assert got[:len(bits)].tolist() == bits
    got = htj2k.mel_bits(H.pack_mel(bits))
    assert got[:len(bits)].tolist() == bits


def test_sigprop_and_magref_worked():
    """A 4 x 4 block coded down to plane 1, significant only at (0, 0)
    (|q| 4: mu 2, plane-0 bit 0), with q = -1 at (1, 0): SigProp visits
    (1, 0) [1], (2, 0) [0] (a neighbour of the new (1, 0)), (0, 1),
    (1, 1), (2, 1) [0 each], then (1, 0)'s sign [1]: 0b100001; MagRef
    reads (0, 0)'s bit [0]. Decoded: (0, 0) at 4 + half, (1, 0) at -(1 +
    half), in the doubled scale."""
    q = np.zeros((4, 4), np.int64)
    q[0, 0], q[1, 0] = 4, -1
    sp, mr = H.refinement_segment(q, 1, 3)
    assert sp == bytes([0b100001]) and mr == bytes([0])
    cu = H.cleanup_segment(q, 1)
    # Mb 3, numbps 2 (p): the cleanup at plane 1, the refinement at 0
    blk = htj2k.Block(cu + sp + mr, len(cu), 2, 3, 3, 2, 4, 4)
    for out in (htj2k.decode_block(blk),
                htj2k.HTBlocks([blk, blk, blk]).decode()[1]):
        want = np.zeros((4, 4), np.int64)
        want[0, 0], want[1, 0] = 2 * 4 + 1, -(2 * 1 + 1)
        np.testing.assert_array_equal(out, want)


def test_ht_texture_step_and_timing_on_cpu(tmp_path):
    """Phase 16's HT parts on the CPU: ht_texture_64.jp2 through
    load_image into a scene whose film is bit-equal to that of its PNG
    twin (chip_smoke.jp2_texture_step, a captured step on the card), and
    ht_decode_timing on a 96 x 96 crop of the smooth timing image (not the
    recorded 1024 x 1024 file, so held to its PSNR bar alone)."""
    import torch

    import chip_smoke
    out = chip_smoke.jp2_texture_step(torch.device("cpu"), tmp_path, 16,
                                      name=chip_smoke.HT_TEXTURE)
    assert out["bit_equal"] and out["finite"] and out["film_mean"] > 0
    assert out["shape"] == [64, 64, 3] and out["device"] == "cpu"
    src = imagelib.decode_samples(chip_smoke.TIMING_FIXTURES
                                  / "smooth_lossless.webp")[:96, :96]
    got = chip_smoke.ht_decode_timing(tmp_path, np.ascontiguousarray(src))
    assert got["psnr_db"] >= chip_smoke.HT_1024_PSNR
    assert not got["recorded_file"]


@pytest.mark.parametrize("scalar", [0, 1 << 20])
def test_refinement_on_some_lanes_of_a_run(monkeypatch, scalar):
    """A run whose wider blocks lose their refinement passes (an empty
    refinement segment: cleanup only, as OpenJPEG decodes them) beside
    narrower ones that keep them: the lockstep refines only the latter,
    each at its own place, as cv2 does (the last tile of a 9 x 71 image
    in 9 x 33 tiles)."""
    monkeypatch.setattr(htj2k, "SCALAR", scalar)
    img = F.photo(71, 9, 34, noise=2.0)[..., 0]
    data = H.encode([img], comps=[H.Comp(2, 4, 6)], tiles=(9, 33),
                    plan=F.plan_all(3, 3, [0, 0, 0]))
    np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data),
                                  _cv2_rgb(data))
