"""AV1 inter frames, read as ignis_tpu's OpenCV (cv2 5.0.0: libavif over
libaom 3.14.1) reads them: AVIF items of a key frame and inter frames
from Pillow's image sequences (scripts/make_inter_fixtures.py, at
libaom speeds 0-10, 4:2:0 / 4:2:2 / 4:4:4, shifts, zooms, rotations and
fades), each held to cv2.imdecode exactly and, through load_image, to
ignis_tpu's load_image; the parts (warps, the motion field projection,
wedge masks) on the fixtures' own numbers; and the two codec faults
repaired beside them: padding and metadata OBUs checked as libaom checks
them, and a JPEG 2000 file whose POC volumes leave two components' top
resolutions out.
"""
from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from ignis_tpu.utils import image as jax_image
from ignis_tpu_torch.utils import av1, av1_inter, av1_mv, avif, jpeg2000
from ignis_tpu_torch.utils import av1_tables as T
from ignis_tpu_torch.utils import image as imagelib

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import make_inter_fixtures as M  # noqa: E402
import make_named_fixtures as F  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
INTER = DATA / "images_inter"
NAMES = sorted(M.FIXTURES)
FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR


def _cv2(data: bytes):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    return np.ascontiguousarray(img[..., 2::-1])


def _decoder(name):
    """The port's decoder after every frame of a fixture."""
    d = av1.Decoder(avif.parse_avif((INTER / f"{name}.avif").read_bytes())
                    ["av1"])
    if d.frame_done:
        d.finish_frame()
    return d


def test_inter_fixture_set():
    """The files are the script's, and together they reach the inter
    tools ROADMAP does not list as untried: every motion mode, compound
    type, global warps, inter-intra, dual filters, skip mode, error
    resilient frames, segmentation and streams without order hints."""
    assert sorted(p.stem for p in INTER.glob("*.avif")) == NAMES
    tools = json.loads((INTER / "tools.json").read_text())
    assert sorted(k for k in tools if k != "all") == NAMES
    got = set(tools["all"])
    for k in ("motion mode: OBMC", "motion mode: local warp",
              "compound: wedge", "compound: difference weighted",
              "compound: distance", "compound: average",
              "reference: compound unidirectional", "inter-intra: wedge",
              "inter-intra: V", "global motion: rotzoom", "mode: GLOBALMV",
              "mode: GLOBAL_GLOBALMV", "block: skip_mode",
              "frame: use_ref_frame_mvs", "frame: primary_ref_frame",
              "frame: error resilient", "frame: segmentation",
              "frame: no order hints"):
        assert k in got, k
    assert any(k.startswith("filter: dual") for k in got)


@pytest.mark.parametrize("name", NAMES)
def test_inter_fixture_matches_cv2(name):
    """Each item reads to live cv2.imdecode's pixels exactly, dtype and
    shape included (cv2 shows the last inter frame)."""
    data = (INTER / f"{name}.avif").read_bytes()
    want = _cv2(data)
    got = avif.decode_avif(data, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_inter_fixture_loads_as_jax(name):
    """ignis_tpu's load_image (cv2.imread, samples as they are) against
    the port's samples, and the port's load_image scaled by 1/255."""
    path = INTER / f"{name}.avif"
    got = imagelib.decode_samples(path)
    for lin in (False, True):
        np.testing.assert_array_equal(
            jax_image.load_image(str(path), linear=lin),
            got.astype(np.float32))
    np.testing.assert_array_equal(imagelib.load_image(path, linear=True),
                                  got.astype(np.float32) / np.float32(255))


def test_tools_json_is_the_decoders_count():
    """tools.json holds what av1.count_tools counts over each file's
    frames (two of the files recounted here)."""
    tools = json.loads((INTER / "tools.json").read_text())
    for name in ("s6_420_shift_24x32_n2", "s0_420_mixed_48x64_n4"):
        assert dict(_decoder(name).tools) == tools[name]


# ---- the parts on a fixture's own numbers ---------------------------------
def _local_warp_blocks(name):
    d = _decoder(name)
    seen = {id(b): b for row in d.mi for b in row
            if b.is_inter and b.motion_mode == av1.LOCALWARP}
    return list(seen.values())


def test_warp_estimation_and_shear_of_fixture_blocks():
    """LocalWarpParams of the local-warp blocks of a fixture's last frame:
    the warp takes the block's centre along its vector exactly (the
    translation terms are solved for that), its linear part is the least
    squares fit of the samples' motion within a hundredth, and
    setupShear's alpha, beta, gamma and delta are the shears of that
    matrix, rounded to multiples of 64."""
    blocks = _local_warp_blocks("s3_420_rotate_128x128_n6")
    assert len(blocks) >= 5
    checked = 0
    for b in blocks:
        p = av1_inter.warp_estimation(b, b.warp)
        assert p is not None
        bw, bh = 4 * av1.BW4[b.size], 4 * av1.BH4[b.size]
        mx, my = b.col * 4 + bw // 2 - 1, b.row * 4 + bh // 2 - 1
        if abs(p[0]) < (1 << 23) - 1 and abs(p[1]) < (1 << 23) - 1:
            assert p[2] * mx + p[3] * my + p[0] == \
                (mx << 16) + (b.mv[0][1] << 13)
            assert p[4] * mx + p[5] * my + p[1] == \
                (my << 16) + (b.mv[0][0] << 13)
        src = np.array([(s[1] - mx * 8, s[0] - my * 8) for s in b.warp], float)
        dst = np.array([(s[3] - mx * 8 - b.mv[0][1],
                         s[2] - my * 8 - b.mv[0][0]) for s in b.warp], float)
        if len(b.warp) >= 3 and np.linalg.matrix_rank(src) == 2:
            fit = np.linalg.lstsq(src, dst, rcond=None)[0].T
            mat = np.array([[p[2], p[3]], [p[4], p[5]]]) / 65536.0
            if np.all(np.abs(fit - np.eye(2)) < 0.12):
                assert np.abs(mat - fit).max() < 0.01, (mat, fit)
                checked += 1
        a, be, g, de, valid = av1_inter.setup_shear(p)
        assert all(v % 64 == 0 for v in (a, be, g, de))
        assert abs(a - (p[2] - 65536)) <= 32 and abs(be - p[3]) <= 32
        assert abs(g - p[4] * 65536 / p[2]) <= 33
        assert abs(de - (p[5] - p[3] * p[4] / p[2] - 65536)) <= 33
        assert valid == (4 * abs(a) + 7 * abs(be) < 65536 and
                         4 * abs(g) + 4 * abs(de) < 65536)
    assert checked >= 3


def test_motion_field_of_a_fixture_frame():
    """The projected motion field of a fixture's last frame: each entry a
    saved vector within REFMVS_LIMIT at a frame distance of 1-31, and
    the projection of 7.9.3 within half a unit plus Div_Mult's rounding
    of mv * num / den over a grid of vectors and distances."""
    d = _decoder("s0_422_shift_64x72_n7")
    mf = d.motion_field
    assert d.use_ref_frame_mvs and mf["valid"].any()
    v = mf["valid"]
    assert (np.abs(mf["mv"][v]) <= av1_mv.REFMVS_LIMIT).all()
    assert ((mf["offset"][v] >= 1) & (mf["offset"][v] <= 31)).all()
    refs, mvs = av1_mv.motion_field_store(d)
    for rf in np.unique(refs[refs > 0]):
        assert d.rel_dist(d.order_hints[rf], d.order_hint) < 0
    for mv, num, den in itertools.product(
            ((37, -5), (-300, 211), (4095, -4095), (0, 17)),
            (-31, -7, -1, 1, 2, 5, 31), (1, 2, 3, 7, 16, 31)):
        got = av1_mv.mv_projection(mv, num, den)
        for g, m in zip(got, mv):
            exact = m * num / den
            slack = 0.5 + abs(m * num) * abs(T.DIV_MULT[den] - 16384 / den) \
                / 16384
            assert abs(g - exact) <= slack or abs(g) == (1 << 14) - 1


WEDGE_SIZES = [b for b in range(22) if av1.WEDGE_BITS[b]]


@pytest.mark.parametrize("bsize", WEDGE_SIZES)
def test_wedge_masks(bsize):
    """The wedge masks of a block size: libaom's sign-flip table is the
    specification's rule (the mean of the master mask's first row and
    column under 32), the two signs complement each other to 64, and
    each mask lies in 0..64 and weighs the two predictions unevenly
    across the block."""
    w, h = 4 * av1.BW4[bsize], 4 * av1.BH4[bsize]
    for i in range(16):
        assert T.WEDGE_SIGNFLIP[bsize][i] == av1_inter.wedge_sign_flip(
            bsize, i)
        m0 = av1_inter.wedge_mask(bsize, 0, i)
        m1 = av1_inter.wedge_mask(bsize, 1, i)
        assert m0.shape == (h, w)
        np.testing.assert_array_equal(m0 + m1, 64)
        assert 0 <= m0.min() < m0.max() <= 64


def test_wedge_masks_of_a_fixture():
    """The wedge compound blocks of a fixture's frames use masks of their
    own size."""
    d = _decoder("s0_420_zoom_96x96_n5")
    n = 0
    for row in d.mi:
        for b in row:
            if b.is_inter and b.comp_type == av1.COMPOUND_WEDGE:
                m = av1_inter.wedge_mask(b.size, b.wedge_sign, b.wedge_index)
                assert m.shape == (4 * av1.BH4[b.size], 4 * av1.BW4[b.size])
                n += 1
    assert d.tools["compound: wedge"] + d.tools["inter-intra: wedge"] >= n


# ---- padding and metadata OBUs ------------------------------------------
def _spliced(payload, kind):
    item, seq = F.key_and_inter()
    obu = bytes([(kind << 3) | 2, len(payload)]) + payload
    return avif.heif_image(item[:2] + obu + item[2:], seq, 32, 24)


OBU_CASES = {
    "padding": (15, b"\x00\x80", True),
    "padding_empty": (15, b"", True),
    "padding_bad_trailing": (15, b"\x12\x34", False),
    "padding_zero": (15, b"\x00\x00", False),
    "t35": (5, b"\x04\xb5\x00\x80", True),
    "t35_bad_trailing": (5, b"\x04\xb5\x00\x81", False),
    "hdr_cll": (5, b"\x01" + bytes(4) + b"\x80", True),
    "hdr_cll_short": (5, b"\x01" + bytes(3), False),
    "private": (5, b"\x06\x05", True),
    "private_zero": (5, b"\x06\x00", False),
    "scalability": (5, b"\x03\x00\x80", True),
    "scalability_bad_trailing": (5, b"\x03\x00\x81", False),
    "scalability_nonzero_tail": (5, b"\x03\x00\x80\x00\x01", False),
}


@pytest.mark.parametrize("case", sorted(OBU_CASES))
def test_padding_and_metadata_obus(case):
    """A padding or metadata OBU spliced into a valid item: where libaom
    refuses its trailing bits cv2 reads nothing and the port raises
    IOError; otherwise both read the item's pixels."""
    kind, payload, ok = OBU_CASES[case]
    data = _spliced(payload, kind)
    want = _cv2(data)
    assert (want is not None) == ok
    if ok:
        np.testing.assert_array_equal(avif.decode_avif(data, "x.avif"), want)
    else:
        with pytest.raises(IOError, match="x.avif"):
            avif.decode_avif(data, "x.avif")


# ---- JPEG 2000: POC volumes that leave resolutions out ------------------
def test_poc_volumes_leaving_resolutions_out():
    """opj_poc_cut.jp2 (48 x 40): its volumes leave components 1 and 2
    at 4 of 6 resolutions. OpenJPEG, and so cv2, rebuilds those two only
    up to resolution 3 and puts that 12 x 10 picture at the corner, the
    rest 0; component 0 is whole. The port reads it to cv2's pixels."""
    data = (DATA / "images" / "opj_poc_cut.jp2").read_bytes()
    want = _cv2(data)
    np.testing.assert_array_equal(jpeg2000.decode_jpeg2000(data), want)
    comps = jpeg2000.decode_components(data)[0]
    assert comps[0].shape == (40, 48) and comps[0].any()
    for c in (1, 2):
        assert comps[c][:10, :12].any()
        assert not comps[c][10:].any() and not comps[c][:, 12:].any()


# ---- chip_smoke.py's inter parts on the CPU -------------------------------
def test_inter_texture_step_and_read_on_cpu(tmp_path):
    """Phase 16's inter parts on the CPU: texture_64x64_n4.avif (a key
    frame and three inter frames) through load_image into a scene whose
    film is bit-equal to that of its PNG twin (chip_smoke.jp2_texture_step,
    a captured step on the card), and a fixture held to its cv2 pixels
    by chip_smoke.inter_read."""
    import torch

    import chip_smoke
    out = chip_smoke.jp2_texture_step(torch.device("cpu"), tmp_path, 16,
                                      name=chip_smoke.INTER_TEXTURE,
                                      folder=chip_smoke.INTER_FIXTURES)
    assert out["bit_equal"] and out["finite"] and out["film_mean"] > 0
    assert out["shape"] == [64, 64, 3] and out["device"] == "cpu"
    got = chip_smoke.inter_read("s10_420_fade_56x40_n5.avif")
    assert got["shape"] == [56, 40, 3] and got["seconds"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_inter_fixture_matches_recorded_pixels(name):
    """cv2_pixels.npz holds cv2's pixels of each item (what chip_smoke.py
    checks against on the card's host, which has no cv2)."""
    want = np.load(INTER / "cv2_pixels.npz")[name]
    np.testing.assert_array_equal(_cv2((INTER / f"{name}.avif")
                                       .read_bytes()), want)
