"""An AV1 decoder: the bitstream of an AVIF image item, read as
the AV1 specification (version 1.0.0 with errata) reads it, to exactly
the planes libaom and dav1d decode.

Read here: OBUs (temporal delimiter, sequence header with either
`reduced_still_picture_header`, the operating points and `color_config`
of every profile; a key or intra-only frame's header; tile groups,
uniform and non-uniform tiles); quantisation (`delta_q_u/v`,
`using_qmatrix`), segmentation, `delta_q` and `delta_lf`, the loop
filter, CDEF and loop restoration parameters, `tx_mode`,
`reduced_tx_set`, `allow_screen_content_tools` and `allow_intrabc`; the
multi-symbol arithmetic decoder with CDF adaptation; the block syntax of
64 x 64 and 128 x 128 superblocks (every partition, skip, `cdef_idx`,
delta q and lf, segment ids, intra modes, angle deltas, CFL alphas,
palettes with their colour cache and anti-diagonal colour contexts,
filter intra, intra block copy, transform size and type) and the
coefficients. Reconstruction and the loop filters are in av1_recon.py,
the constant tables in av1_tables.py.

Superres: the frame is coded at FrameWidth (at least Min(16,
UpscaledWidth), as libaom keeps it) and upscaled before loop restoration
(av1_filters.upscale). A temporal unit of several frames is read as
libaom reads it: each frame reconstructed when the next header comes,
kept in the reference slots its refresh_frame_flags name, the last frame
shown the output (`show_existing_frame` shows a slot's frame with the
film grain stored with it). Film grain is synthesised on the output
(av1_grain.py). Inter frames are read too: their uncompressed header
(the references, frame_refs_short_signaling, sizes from the references,
interpolation filter, motion modes, skip mode, global motion and the
state loaded from the primary reference frame), the inter block syntax
and the reference slots' saved state (7.20, 7.21); motion vector
prediction is in av1_mv.py, inter prediction in av1_inter.py. An inter
frame with nothing decoded before it, a tile list OBU (large-scale
tile), a padding or metadata OBU whose trailing bits libaom refuses, and
a superres tile column under 128 coded pixels raise IOError, as libaom
reads nothing of them.
"""
from __future__ import annotations

import collections
import copy

import numpy as np

from . import av1_tables as T

# block sizes: width and height in 4 x 4 units, and their log2
BW4 = (1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16)
BH4 = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4)
BLOG2W = tuple(v.bit_length() - 1 for v in BW4)
BLOG2H = tuple(v.bit_length() - 1 for v in BH4)
_BSIZE = {(BW4[b], BH4[b]): b for b in range(22)}
B4X4, B8X8, B64X64, B128X128 = 0, 3, 12, 15
SUPERRES_NUM = 8

# transform sizes: width and height in pixels
TXW = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
TXH = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)
TXLW = tuple(v.bit_length() - 1 for v in TXW)
TXLH = tuple(v.bit_length() - 1 for v in TXH)
_TXSIZE = {(TXW[t], TXH[t]): t for t in range(19)}
TX_4X4 = 0
TX_SQR = tuple(_TXSIZE[(min(TXW[t], TXH[t]),) * 2] for t in range(19))
TX_SQR_UP = tuple(_TXSIZE[(max(TXW[t], TXH[t]),) * 2] for t in range(19))
TX_ADJ = tuple(_TXSIZE[(min(TXW[t], 32), min(TXH[t], 32))]
               for t in range(19))
SPLIT_TX = (0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10)
MAX_TX_RECT = tuple(_TXSIZE[(min(4 * BW4[b], 64), min(4 * BH4[b], 64))]
                    for b in range(22))


def _depth(t):
    d = 0
    while t != TX_4X4:
        t = SPLIT_TX[t]
        d += 1
    return d


MAX_TX_DEPTH = tuple(min(_depth(MAX_TX_RECT[b]), 2) for b in range(22))
TX_CAT = tuple(max(_depth(MAX_TX_RECT[b]) - 1, 0) for b in range(22))

# prediction modes
DC_PRED, V_PRED, H_PRED, D45, D135, D113, D157, D203, D67 = range(9)
SMOOTH, SMOOTH_V, SMOOTH_H, PAETH, UV_CFL = 9, 10, 11, 12, 13
INTRA_MODE_CTX = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
FILTER_INTRA_DIR = (DC_PRED, V_PRED, H_PRED, D157, DC_PRED)

# transform types and classes
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST,
 H_ADST, V_FLIPADST, H_FLIPADST) = range(16)
CLASS_2D, CLASS_HORIZ, CLASS_VERT = 0, 1, 2
TX_CLASS = tuple(CLASS_VERT if t in (V_DCT, V_ADST, V_FLIPADST) else
                 CLASS_HORIZ if t in (H_DCT, H_ADST, H_FLIPADST) else
                 CLASS_2D for t in range(16))
INTRA_SET1 = (IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
INTRA_SET2 = (IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
INTER_SET1 = (IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
              DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST,
              ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST)
INTER_SET2 = (IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
              DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST,
              FLIPADST_ADST)
INTER_SET3 = (IDTX, DCT_DCT)
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT,
                DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                ADST_ADST, DCT_DCT)
(SET_DCTONLY, SET_INTRA_1, SET_INTRA_2, SET_INTER_1, SET_INTER_2,
 SET_INTER_3) = range(6)
_IN_SET = {SET_DCTONLY: (DCT_DCT,), SET_INTRA_1: INTRA_SET1,
           SET_INTRA_2: INTRA_SET2, SET_INTER_1: INTER_SET1,
           SET_INTER_2: INTER_SET2, SET_INTER_3: INTER_SET3}

# frame types, reference frames, interpolation filters, global motion
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)
NONE_FRAME, INTRA_FRAME = -1, 0
(LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME, BWDREF_FRAME,
 ALTREF2_FRAME, ALTREF_FRAME) = range(1, 8)
PRIMARY_REF_NONE = 7
EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE = range(5)
IDENTITY, TRANSLATION, ROTZOOM, AFFINE = range(4)
LF_REF_DELTAS = (1, 0, 0, 0, -1, 0, -1, -1)
# inter modes (YMode of an inter block), motion modes, compound types
NEARESTMV, NEARMV, GLOBALMV, NEWMV = range(13, 17)
(NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV, NEAR_NEWMV,
 NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV) = range(17, 25)
SIMPLE, OBMC, LOCALWARP = range(3)
(COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE, COMPOUND_INTRA,
 COMPOUND_DISTANCE) = range(5)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2,
              2)
WEDGE_BITS = (0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 0,
              0)
COMPOUND_MODE_CTX_MAP = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))
HAS_NEWMV = frozenset((NEWMV, NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV,
                       NEAR_NEWMV, NEW_NEARMV))

PALETTE_COLOR_CONTEXT = (-1, -1, 0, -1, -1, 4, 3, 2, 1)
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
WIENER_MIN, WIENER_MAX, WIENER_K = (-5, -23, -17), (10, 8, 46), (1, 2, 3)
WIENER_MID = (3, -7, 15)
SGR_MIN, SGR_MAX, SGR_MID = (-96, -32), (31, 95), (-32, 31)
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
REMAP_LR = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER,
            RESTORE_SGRPROJ)


def _cdfs(table):
    """A nested table of CDFs in the specification's form (the first N - 1
    cumulative values) as adaptable lists [c0 .. c(N-2), 32768, count]."""
    if table and isinstance(table[0], int):
        return list(table) + [32768, 0]
    return [_cdfs(t) for t in table]


_DEFAULTS = None
_COEFF_CDFS = ("COEFF_BASE_EOB", "COEFF_BASE", "COEFF_BR", "EOB_PT_16",
               "EOB_PT_32", "EOB_PT_64", "EOB_PT_128", "EOB_PT_256",
               "EOB_PT_512", "EOB_PT_1024", "EOB_EXTRA", "TXB_SKIP",
               "DC_SIGN")


def _default_cdfs():
    global _DEFAULTS
    if _DEFAULTS is None:
        names = ("KF_Y_MODE", "UV_MODE_CFL_NOT_ALLOWED", "UV_MODE_CFL_ALLOWED",
                 "PARTITION", "INTRA_TX_SET1", "INTRA_TX_SET2",
                 "INTER_TX_SET1", "INTER_TX_SET2", "INTER_TX_SET3",
                 "CFL_SIGN", "CFL_ALPHA", "ANGLE_DELTA", "PALETTE_Y_SIZE",
                 "PALETTE_UV_SIZE", "PALETTE_Y_COLOR", "PALETTE_UV_COLOR",
                 "PALETTE_Y_MODE", "PALETTE_UV_MODE", "SKIP", "SEGMENT_ID",
                 "TX_SIZE", "USE_FILTER_INTRA", "FILTER_INTRA_MODE",
                 "DELTA_Q", "DELTA_LF", "INTRABC", "RESTORATION_TYPE",
                 "USE_WIENER", "USE_SGRPROJ", "COEFF_BASE_EOB", "COEFF_BASE",
                 "COEFF_BR", "EOB_PT_16", "EOB_PT_32", "EOB_PT_64",
                 "EOB_PT_128", "EOB_PT_256", "EOB_PT_512", "EOB_PT_1024",
                 "EOB_EXTRA", "TXB_SKIP", "DC_SIGN", "Y_MODE", "IS_INTER",
                 "COMP_MODE", "COMP_REF_TYPE", "UNI_COMP_REF", "COMP_REF",
                 "COMP_BWDREF", "SINGLE_REF", "COMPOUND_MODE", "NEW_MV",
                 "ZERO_MV", "REF_MV", "DRL_MODE", "INTERINTRA",
                 "INTERINTRA_MODE", "WEDGE_INTERINTRA", "WEDGE_INDEX",
                 "MOTION_MODE", "USE_OBMC", "COMPOUND_TYPE",
                 "COMP_GROUP_IDX", "COMPOUND_IDX", "INTERP_FILTER",
                 "SKIP_MODE", "SEGMENT_ID_PREDICTED")
        _DEFAULTS = {n: _cdfs(getattr(T, n)) for n in names}
        _DEFAULTS["DELTA_LF_MULTI"] = [_cdfs(T.DELTA_LF) for _ in range(4)]
        from .av1_mv import MV_CDFS
        _DEFAULTS.update(MV_CDFS())
    return _DEFAULTS


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.bitpos = data, pos * 8

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.bitpos >> 3] if (self.bitpos >> 3) < len(
                self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.bitpos & 7))) & 1)
            self.bitpos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def byte_align(self):
        self.bitpos = (self.bitpos + 7) & ~7


def leb128(data, pos):
    v = 0
    for i in range(8):
        b = data[pos + i]
        v |= (b & 0x7f) << (7 * i)
        if not b & 0x80:
            return v, pos + i + 1
    return v, pos + 8


class SymbolDecoder:
    """The multi-symbol arithmetic decoder (spec 8.2). The window `dif`
    holds the inverted bits of the stream (1s past its end) less what the
    decoded intervals took, with `cnt` bits more than the spec's 15.

    Every read takes a `want`, the value an encoder writes there
    (av1_enc.py drives the parse with SymbolEncoder and SymbolCounter,
    which answer each read with it); a decoder passes it by."""

    def __init__(self, data, start, size, disable_update):
        self.data, self.pos, self.end = data, start, start + size
        self.update = not disable_update
        self.dif, self.cnt = 0, -15
        self._refill()
        self.rng = 1 << 15

    def _refill(self):
        d, p, e = self.data, self.pos, self.end
        chunk = d[p:p + 6] if p + 6 <= e else d[p:e] + b"\0" * (6 - max(
            0, e - p))
        self.pos = p + 6
        self.dif = (self.dif << 48) | (~int.from_bytes(chunk, "big")
                                       & 0xffffffffffff)
        self.cnt += 48

    def symbol(self, cdf, want=None) -> int:
        n = len(cdf) - 1
        rng = self.rng
        c = self.cnt
        top = self.dif >> c
        r8 = rng >> 8
        s = -1
        cur = rng
        while True:
            s += 1
            prev = cur
            cur = ((r8 * ((32768 - cdf[s]) >> 6)) >> 1) + 4 * (n - s - 1)
            if top >= cur:
                break
        rng = prev - cur
        self.dif -= cur << c
        bits = 16 - rng.bit_length()
        self.rng = rng << bits
        c -= bits
        if c < 16:
            self.cnt = c
            self.dif &= (1 << (c + 16)) - 1
            self._refill()
        else:
            self.cnt = c
        if self.update:
            adapt(cdf, s)
        return s

    def bool(self, want=None) -> int:
        return self.symbol([16384, 32768, 0])

    def literal(self, n: int, want=None) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bool()
        return v

    def ns(self, n: int, want=None) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        return v if v < m else (v << 1) - m + self.literal(1)


def adapt(cdf, s):
    """The CDF update after symbol `s` (spec 8.2.6), with its counter."""
    n = len(cdf) - 1
    cnt = cdf[n]
    rate = 3 + (cnt > 15) + (cnt > 31) + (2 if n > 3 else n >> 1)
    for i in range(n - 1):
        if i < s:
            cdf[i] -= cdf[i] >> rate
        else:
            cdf[i] += (32768 - cdf[i]) >> rate
    if cnt < 32:
        cdf[n] = cnt + 1


class SymbolEncoder:
    """libaom's multi-symbol arithmetic encoder (od_ec_encode_q15 with the
    16-bit pre-carry buffer, od_ec_enc_done's shortest tail and its carry
    propagation): the exact inverse of SymbolDecoder, with the same CDF
    adaptation. Each read of the parse writes its `want`."""

    def __init__(self, disable_update=False):
        self.update = not disable_update
        self.low, self.rng, self.cnt = 0, 0x8000, -9
        self.precarry = []

    def symbol(self, cdf, want) -> int:
        s = want
        n = len(cdf) - 1
        r = self.rng
        low = self.low
        r8 = r >> 8
        v = ((r8 * ((32768 - cdf[s]) >> 6)) >> 1) + 4 * (n - s - 1)
        if s > 0:
            u = ((r8 * ((32768 - cdf[s - 1]) >> 6)) >> 1) + 4 * (n - s)
            low += r - u
            r = u - v
        else:
            r -= v
        d = 16 - r.bit_length()
        c = self.cnt
        s_ = c + d
        if s_ >= 0:
            c += 16
            m = (1 << c) - 1
            if s_ >= 8:
                self.precarry.append(low >> c)
                low &= m
                c -= 8
                m >>= 8
            self.precarry.append(low >> c)
            s_ = c + d - 24
            low &= m
        self.low, self.rng, self.cnt = low << d, r << d, s_
        if self.update:
            adapt(cdf, s)
        return s

    def bool(self, want) -> int:
        return self.symbol([16384, 32768, 0], want)

    def literal(self, n: int, want) -> int:
        for i in range(n - 1, -1, -1):
            self.bool((want >> i) & 1)
        return want

    def ns(self, n: int, want) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        if want < m:
            self.literal(w - 1, want)
        else:
            self.literal(w - 1, (want + m) >> 1)
            self.literal(1, (want + m) & 1)
        return want

    def done(self) -> bytes:
        """The coded bytes: the fewest that decode every symbol written,
        whatever follows them."""
        low, c = self.low, self.cnt
        buf = list(self.precarry)
        m = 0x3fff
        e = ((low + m) & ~m) | (m + 1)
        s = c + 10
        if s > 0:
            n = (1 << (c + 16)) - 1
            while True:
                buf.append(e >> (c + 16))
                e &= n
                s -= 8
                c -= 8
                n >>= 8
                if s <= 0:
                    break
        out = bytearray(len(buf))
        carry = 0
        for i in range(len(buf) - 1, -1, -1):
            carry += buf[i]
            out[i] = carry & 0xff
            carry >>= 8
        return bytes(out)


_COST = None


def symbol_costs():
    """-log2(p / 32768) in bits for every 15-bit probability p."""
    global _COST
    if _COST is None:
        p = np.arange(32769, dtype=np.float64)
        p[0] = 0.5
        _COST = (15.0 - np.log2(p)).tolist()
    return _COST


class SymbolCounter:
    """Answers the parse's reads like SymbolEncoder but only adds up their
    cost in bits (`bits`), from the CDFs as they stand: it adapts none, so
    a rate-distortion search can try a block many times over."""

    def __init__(self):
        self.bits = 0.0
        self.cost = symbol_costs()

    def symbol(self, cdf, want) -> int:
        lo = cdf[want - 1] if want else 0
        self.bits += self.cost[cdf[want] - lo]
        return want

    def bool(self, want) -> int:
        self.bits += 1.0
        return want

    def literal(self, n: int, want) -> int:
        self.bits += n
        return want

    def ns(self, n: int, want) -> int:
        w = n.bit_length()
        self.bits += w - 1 + (want >= (1 << w) - n)
        return want


class BitWriter:
    """The header bit writer: f(n) and su(n) of the specification, MSB
    first, with trailing_bits and byte_alignment."""

    def __init__(self):
        self.bits = []

    def f(self, n: int, v: int):
        v = int(v)
        if v < 0 or v >> n:
            raise ValueError(f"AV1 header: {v} does not fit {n} bits")
        self.bits += [(v >> i) & 1 for i in range(n - 1, -1, -1)]

    def su(self, n: int, v: int):
        self.f(n, v & ((1 << n) - 1))

    def ns(self, n: int, v: int):
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            self.f(w - 1, v)
        else:
            self.f(w - 1, (v + m) >> 1)
            self.f(1, (v + m) & 1)

    def trailing_bits(self):
        self.bits.append(1)
        self.byte_align()

    def byte_align(self):
        self.bits += [0] * (-len(self.bits) % 8)

    def bytes(self) -> bytes:
        if len(self.bits) % 8:
            raise ValueError("AV1 header: not byte aligned")
        arr = np.array(self.bits, np.uint8)
        return np.packbits(arr).tobytes()


def leb128_bytes(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7f
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


class Frame:
    """The decoded image: `planes` (int32 [h, w] each, cropped), the bit
    depth, subsampling and colour description."""


class Block:
    """A block's mode info. An inter block's `ref` is (RefFrame[0],
    RefFrame[1]) and `mv` its two vectors (row, col) in 1/8 sample; an
    intra block's `ref` is (INTRA_FRAME, NONE_FRAME)."""
    __slots__ = ("size", "skip", "is_inter", "y_mode", "uv_mode", "seg",
                 "tx_size", "pal_size", "pal_colors", "delta_lf",
                 "use_intrabc", "mv", "angle_y", "angle_uv", "cfl_u",
                 "cfl_v", "filter_mode", "color_map_y", "color_map_uv",
                 "pal_v", "row", "col", "lossless", "qindex", "avail",
                 "var_tx", "ref", "skip_mode", "interp", "motion_mode",
                 "comp_type", "interintra", "ii_mode", "wedge_ii",
                 "wedge_index", "wedge_sign", "mask_type", "comp_group",
                 "comp_idx", "warp", "ref_mv_idx", "mask")


class Decoder:
    """Parses one AV1 still image (its OBUs) into the frame header, the
    mode info of every block and, in decode order, the transform blocks
    that av1_recon.py reconstructs."""

    def __init__(self, data: bytes, name: str = ""):
        self.name = name
        self.seq = None
        self.frame_done = False
        # the reference slots: (pre-grain Frame, grain params, frame type)
        self.slots = [None] * 8
        # what else each slot keeps (7.20): order hints, sizes, motion
        # field, segment ids, loop filter deltas, CDFs, global motion
        self.saved = [None] * 8
        self.output = None          # (Frame, grain params) shown last
        self.showed_existing = False
        self.tools = collections.Counter()     # count_tools of each frame
        self.parse_obus(data)

    # ---- OBUs -------------------------------------------------------------
    def parse_obus(self, data):
        """Every OBU of the temporal unit. A frame parsed in full waits
        for its reconstruction until another frame header follows it
        (finish_frame), so that the last frame shown is the output, as
        libaom gives it."""
        pos = 0
        while pos < len(data):
            h = data[pos]
            kind = (h >> 3) & 15
            ext, has_size = (h >> 2) & 1, (h >> 1) & 1
            p = pos + 1 + ext
            if has_size:
                size, p = leb128(data, p)
            else:
                size = len(data) - p
            end = p + size
            if end > len(data):
                raise IOError(f"AV1: truncated OBU ({self.name})")
            if kind == 1:
                self.sequence_header(BitReader(data, p))
            elif kind in (3, 6):
                if self.seq is None:
                    raise IOError("AV1: frame before a sequence header")
                if self.frame_done:
                    self.finish_frame()
                br = BitReader(data, p)
                if self.frame_header(br) and kind == 6:
                    br.byte_align()
                    self.tile_group(data, br.bitpos >> 3, end)
            elif kind == 4:
                if self.frame_done or not hasattr(self, "mi_cols"):
                    raise IOError(f"AV1: a tile group outside a frame "
                                  f"({self.name})")
                self.tile_group(data, p, end)
            elif kind == 8:
                raise IOError(f"AV1: a tile list OBU, which libaom reads "
                              f"only in large-scale tile mode ({self.name})")
            elif kind == 5:
                self.metadata(data, p, end)
            elif kind == 15 and size and _last_nonzero(data, p, end) != 0x80:
                raise IOError(f"AV1: a padding OBU whose trailing bits are "
                              f"malformed, which libaom refuses ({self.name})")
            pos = end
        if not self.frame_done and self.output is None:
            raise IOError(f"AV1: no complete frame ({self.name})")

    def metadata(self, data, p, end):
        """Checks a metadata OBU (5.8) as libaom's read_metadata does: its
        trailing bits (the last nonzero byte 0x80, or trailing_bits after
        the scalability or timecode syntax with zero bytes after them);
        IOError where libaom, and so cv2, reads nothing of the unit."""
        def bad(why):
            raise IOError(f"AV1: a metadata OBU {why}, which libaom refuses "
                          f"({self.name})")
        q, kind = p, 0
        for i in range(8):
            if q >= end:
                bad("without its type")
            kind |= (data[q] & 0x7f) << (7 * i)
            q += 1
            if not data[q - 1] & 0x80:
                break
        else:
            bad("without its type")
        if kind == 0 or kind >= 6:
            if _last_nonzero(data, q, end) == 0:
                bad("without trailing bits")
            return
        if kind == 4:                               # ITU-T T.35
            n = 1 + (q < end and data[q] == 0xff)
            idx = _last_nonzero_index(data, q, end)
            if end - q < n or idx < q + n or data[idx] != 0x80:
                bad("whose trailing bits are malformed")
            return
        if kind in (1, 2):                          # HDR CLL, MDCV
            q += 4 if kind == 1 else 24
            if q > end or _last_nonzero(data, q, end) != 0x80:
                bad("whose trailing bits are malformed")
            return
        br = BitReader(data, q)
        if kind == 3:                               # scalability
            if br.f(8) == 14:
                n = br.f(2) + 1
                dims, desc, group = br.f(1), br.f(1), br.f(1)
                br.f(3)
                if dims:
                    br.f(32 * n)
                if desc:
                    br.f(8 * n)
                if group:
                    for _ in range(br.f(8)):
                        br.f(5)
                        br.f(8 * br.f(3))
        else:                                       # timecode
            br.f(5)
            full = br.f(1)
            br.f(11)
            if full:
                br.f(17)
            elif br.f(1):
                br.f(6)
                if br.f(1):
                    br.f(6)
                    if br.f(1):
                        br.f(5)
            br.f(br.f(5))
        k = 8 - br.bitpos % 8
        if br.f(k) != 1 << (k - 1):
            bad("whose trailing bits are malformed")
        if br.bitpos > end * 8 or any(data[br.bitpos >> 3:end]):
            bad("whose trailing bits are malformed")

    def finish_frame(self):
        """Reconstructs the frame parsed last, stores it in the slots its
        refresh_frame_flags name, and makes it the output if shown."""
        from .av1_recon import reconstruct
        frame = reconstruct(self)
        if getattr(self, "tools", None) is not None:
            count_tools(self, self.tools)
        if self.refresh:
            saved = self.frame_state()
            for i in range(8):
                if self.refresh >> i & 1:
                    self.slots[i] = (frame, self.grain, self.frame_type)
                    self.saved[i] = saved
        if self.show_frame:
            self.output = (frame, self.grain)
        self.frame_done = False

    def frame_state(self):
        """What the reference frame update (7.20) keeps of this frame
        beside its planes: order hints, sizes, the motion field (7.19),
        segment ids, the loop filter deltas, segmentation features, the
        CDFs (those at the end of tile context_update_tile_id, counters
        cleared, unless disable_frame_end_update_cdf) and the global
        motion parameters."""
        from .av1_mv import motion_field_store
        seg = np.array([[b.seg for b in row] for row in self.mi], np.int8)
        if self.seg_enabled and not self.seg_update_map:
            seg = self.prev_seg.copy()
        cdf = self.frame_cdf
        if not self.disable_frame_end_cdf:
            cdf = self.end_cdf
            _clear_counts(cdf)
        refs, mvs = motion_field_store(self)
        return {"order_hint": self.order_hint,
                "order_hints": list(self.order_hints), "up_w": self.up_w,
                "w": self.w, "h": self.h, "mi_rows": self.mi_rows,
                "mi_cols": self.mi_cols, "frame_type": self.frame_type,
                "mf_refs": refs, "mf_mvs": mvs, "seg": seg,
                "seg_feat": self.seg_feat,
                "lf_ref_deltas": list(self.lf_ref_deltas),
                "lf_mode_deltas": list(self.lf_mode_deltas), "cdf": cdf,
                "gm": [list(g) for g in self.gm]}

    def sequence_header(self, br):
        s = {}
        s["profile"] = br.f(3)
        br.f(1)                                     # still_picture
        s["reduced"] = br.f(1)
        s["decoder_model"] = 0
        s["equal_interval"] = 0
        if s["reduced"]:
            s["level"] = br.f(5)
            s["op_idc"] = [0]
            s["dm_op"] = [0]
        else:
            timing = br.f(1)
            if timing:
                br.f(32)
                br.f(32)
                s["equal_interval"] = br.f(1)
                if s["equal_interval"]:
                    br.uvlc()
                s["decoder_model"] = br.f(1)
                if s["decoder_model"]:
                    s["buf_delay_len"] = br.f(5) + 1
                    br.f(32)
                    s["removal_len"] = br.f(5) + 1
                    s["pres_len"] = br.f(5) + 1
            idd = br.f(1)
            n = br.f(5) + 1
            s["op_idc"], s["dm_op"] = [], []
            for _ in range(n):
                s["op_idc"].append(br.f(12))
                lvl = br.f(5)
                s.setdefault("level", lvl)
                if lvl > 7:
                    br.f(1)
                dm = 0
                if s["decoder_model"]:
                    dm = br.f(1)
                    if dm:
                        br.f(s["buf_delay_len"])
                        br.f(s["buf_delay_len"])
                        br.f(1)
                s["dm_op"].append(dm)
                if idd and br.f(1):
                    br.f(4)
        wb, hb = br.f(4) + 1, br.f(4) + 1
        s["wbits"], s["hbits"] = wb, hb
        s["max_w"], s["max_h"] = br.f(wb) + 1, br.f(hb) + 1
        s["frame_ids"] = 0 if s["reduced"] else br.f(1)
        if s["frame_ids"]:
            s["delta_id_len"] = br.f(4) + 2
            s["id_len"] = br.f(3) + 1 + s["delta_id_len"]
        s["sb128"] = br.f(1)
        s["filter_intra"] = br.f(1)
        s["edge_filter"] = br.f(1)
        s["order_hint_bits"] = 0
        for k in ("interintra", "masked", "warped_motion", "dual_filter",
                  "jnt_comp", "ref_frame_mvs"):
            s[k] = 0
        if s["reduced"]:
            s["force_sct"], s["force_imv"] = 2, 2
        else:
            for k in ("interintra", "masked", "warped_motion",
                      "dual_filter"):
                s[k] = br.f(1)
            order_hint = br.f(1)
            if order_hint:
                s["jnt_comp"], s["ref_frame_mvs"] = br.f(1), br.f(1)
            if br.f(1):
                s["force_sct"] = 2
            else:
                s["force_sct"] = br.f(1)
            if s["force_sct"] > 0:
                s["force_imv"] = 2 if br.f(1) else br.f(1)
            else:
                s["force_imv"] = 2
            if order_hint:
                s["order_hint_bits"] = br.f(3) + 1
        s["superres"] = br.f(1)
        s["cdef"] = br.f(1)
        s["restoration"] = br.f(1)
        # color_config
        hbd = br.f(1)
        if s["profile"] == 2 and hbd:
            s["bd"] = 12 if br.f(1) else 10
        else:
            s["bd"] = 10 if hbd else 8
        s["mono"] = 0 if s["profile"] == 1 else br.f(1)
        if br.f(1):
            s["cp"], s["tc"], s["mc"] = br.f(8), br.f(8), br.f(8)
        else:
            s["cp"] = s["tc"] = s["mc"] = 2
        if s["mono"]:
            s["full_range"] = br.f(1)
            s["ssx"] = s["ssy"] = 1
            s["sep_uv"] = 0
        else:
            if s["cp"] == 1 and s["tc"] == 13 and s["mc"] == 0:
                s["full_range"] = 1
                s["ssx"] = s["ssy"] = 0
            else:
                s["full_range"] = br.f(1)
                if s["profile"] == 0:
                    s["ssx"] = s["ssy"] = 1
                elif s["profile"] == 1:
                    s["ssx"] = s["ssy"] = 0
                elif s["bd"] == 12:
                    s["ssx"] = br.f(1)
                    s["ssy"] = br.f(1) if s["ssx"] else 0
                else:
                    s["ssx"], s["ssy"] = 1, 0
                if s["ssx"] and s["ssy"]:
                    br.f(2)
            s["sep_uv"] = br.f(1)
        s["film_grain"] = br.f(1)
        self.seq = s

    def frame_header(self, br):
        """Reads an uncompressed header (5.9); False where it shows an
        existing frame (show_existing_frame: that slot's frame, with the
        film grain stored with it, becomes the output; no tiles follow)."""
        s = self.seq
        obh = s["order_hint_bits"]
        if s["reduced"]:
            frame_type, show_frame, showable = KEY_FRAME, 1, 0
            error_res = 1
        else:
            if br.f(1):
                idx = br.f(3)
                if s["decoder_model"] and not s["equal_interval"]:
                    br.f(s["pres_len"])
                if s["frame_ids"]:
                    br.f(s["id_len"])
                if self.slots[idx] is None:
                    raise IOError(f"AV1: show_existing_frame of an empty "
                                  f"slot ({self.name})")
                frame, grain, kind = self.slots[idx]
                self.output = (frame, grain)
                self.showed_existing = True
                if kind == KEY_FRAME:       # a key frame refreshes all
                    self.slots = [self.slots[idx]] * 8
                    self.saved = [self.saved[idx]] * 8
                return False
            frame_type = br.f(2)
            show_frame = br.f(1)
            if show_frame and s["decoder_model"] and not s["equal_interval"]:
                br.f(s["pres_len"])
            showable = int(frame_type != KEY_FRAME) if show_frame else br.f(1)
            error_res = 1 if frame_type == SWITCH_FRAME or (
                frame_type == KEY_FRAME and show_frame) else br.f(1)
        intra = frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)
        if not intra and not any(self.slots):
            raise IOError(f"AV1: an inter frame with no frame decoded "
                          f"before it to refer to ({self.name})")
        self.frame_is_intra, self.error_res = intra, error_res
        self.disable_cdf_update = br.f(1)
        if s["force_sct"] == 2:
            self.sct = br.f(1)
        else:
            self.sct = s["force_sct"]
        self.force_imv = 0
        if self.sct:
            self.force_imv = br.f(1) if s["force_imv"] == 2 else \
                s["force_imv"]
        if intra:
            self.force_imv = 1
        if s["frame_ids"]:
            br.f(s["id_len"])
        if frame_type == SWITCH_FRAME:
            size_override = 1
        else:
            size_override = 0 if s["reduced"] else br.f(1)
        self.order_hint = br.f(obh)
        self.primary_ref = PRIMARY_REF_NONE if intra or error_res else \
            br.f(3)
        if s["decoder_model"]:
            if br.f(1):
                for idc, dm in zip(s["op_idc"], s["dm_op"]):
                    if dm and (idc == 0 or ((idc & 1) and (idc >> 8) & 1)):
                        br.f(s["removal_len"])
        self.allow_hp = self.use_ref_frame_mvs = self.allow_intrabc = 0
        refresh = 0xff
        if not (frame_type == SWITCH_FRAME or
                (frame_type == KEY_FRAME and show_frame)):
            refresh = br.f(8)
        if (not intra or refresh != 0xff) and error_res and obh:
            for i in range(8):
                hint = br.f(obh)
                if self.saved[i] is None or \
                        self.saved[i]["order_hint"] != hint:
                    # RefValid 0: the slot keeps only this order hint
                    self.slots[i] = None
                    self.saved[i] = {"order_hint": hint}
        self.frame_type, self.show_frame, self.refresh = (
            frame_type, show_frame, refresh)
        self.ref_idx = [0] * 7
        if intra:
            self.frame_size(br, size_override)
            self.allow_intrabc = br.f(1) if self.sct and \
                self.up_w == self.w else 0
        else:
            short = br.f(1) if obh else 0
            if short:
                last, gold = br.f(3), br.f(3)
                self.set_frame_refs(last, gold)
            for i in range(7):
                if not short:
                    self.ref_idx[i] = br.f(3)
                if s["frame_ids"]:
                    br.f(s["delta_id_len"])
                if self.slots[self.ref_idx[i]] is None:
                    raise IOError(f"AV1: an inter frame refers to an empty "
                                  f"slot ({self.name})")
            if size_override and not error_res:
                self.frame_size_with_refs(br)
            else:
                self.frame_size(br, size_override)
            self.allow_hp = 0 if self.force_imv else br.f(1)
            self.interp_filter = SWITCHABLE if br.f(1) else br.f(2)
            self.motion_switchable = br.f(1)
            self.use_ref_frame_mvs = 0 if error_res or not \
                s["ref_frame_mvs"] else br.f(1)
        # OrderHints and RefFrameSignBias of LAST_FRAME .. ALTREF_FRAME
        self.order_hints = [self.order_hint] + [
            0 if intra else self.saved[self.ref_idx[i]]["order_hint"]
            for i in range(7)]
        self.sign_bias = [0] + [int(self.rel_dist(h, self.order_hint) > 0)
                                for h in self.order_hints[1:]]
        if s["reduced"] or self.disable_cdf_update:
            self.disable_frame_end_cdf = 1
        else:
            self.disable_frame_end_cdf = br.f(1)
        prev = None if self.primary_ref == PRIMARY_REF_NONE else \
            self.saved[self.ref_idx[self.primary_ref]]
        self.tile_info(br)
        # quantization_params
        self.base_q = br.f(8)
        self.dq = [[0, 0], [0, 0], [0, 0]]          # [plane][dc, ac]
        self.dq[0][0] = self._delta_q(br)
        if not s["mono"]:
            diff_uv = br.f(1) if s["sep_uv"] else 0
            self.dq[1][0] = self._delta_q(br)
            self.dq[1][1] = self._delta_q(br)
            if diff_uv:
                self.dq[2][0] = self._delta_q(br)
                self.dq[2][1] = self._delta_q(br)
            else:
                self.dq[2] = list(self.dq[1])
        self.using_qm = br.f(1)
        self.qm = [15, 15, 15]
        if self.using_qm:
            qy, qu = br.f(4), br.f(4)
            qv = br.f(4) if s["sep_uv"] else qu
            self.qm = [qy, qu, qv]
        self.segmentation_params(br, prev)
        # delta_q, delta_lf
        self.delta_q_present = br.f(1) if self.base_q > 0 else 0
        self.delta_q_res = br.f(2) if self.delta_q_present else 0
        self.delta_lf_present = self.delta_lf_res = self.delta_lf_multi = 0
        if self.delta_q_present:
            if not self.allow_intrabc:
                self.delta_lf_present = br.f(1)
            if self.delta_lf_present:
                self.delta_lf_res = br.f(2)
                self.delta_lf_multi = br.f(1)
        # the frame's CDFs: the defaults (coefficient CDFs by base_q_idx)
        # or those saved with the primary reference frame
        if prev is None:
            q = self.base_q
            qctx = 0 if q <= 20 else 1 if q <= 60 else 2 if q <= 120 else 3
            self.frame_cdf = {k: v[qctx] if k in _COEFF_CDFS else v
                              for k, v in _default_cdfs().items()}
        else:
            self.frame_cdf = prev["cdf"]
        self.lossless = []
        for sid in range(8):
            q = self.qidx(sid, None)
            self.lossless.append(
                q == 0 and self.dq[0][0] == 0 and self.dq[1] == [0, 0]
                and self.dq[2] == [0, 0])
        self.coded_lossless = all(self.lossless)
        all_lossless = self.coded_lossless and self.w == self.up_w
        self.seg_qm = [[15 if self.lossless[sid] or not self.using_qm
                        else self.qm[p] for sid in range(8)]
                       for p in range(3)]
        # loop filter
        self.lf_level = [0, 0, 0, 0]
        self.lf_sharp = 0
        self.lf_delta_enabled = 0
        self.lf_ref_deltas = list(LF_REF_DELTAS)
        self.lf_mode_deltas = [0, 0]
        if prev is not None:
            self.lf_ref_deltas = list(prev["lf_ref_deltas"])
            self.lf_mode_deltas = list(prev["lf_mode_deltas"])
        if self.coded_lossless or self.allow_intrabc:
            self.lf_ref_deltas = list(LF_REF_DELTAS)
            self.lf_mode_deltas = [0, 0]
        else:
            self.lf_level[0], self.lf_level[1] = br.f(6), br.f(6)
            if not s["mono"] and (self.lf_level[0] or self.lf_level[1]):
                self.lf_level[2], self.lf_level[3] = br.f(6), br.f(6)
            self.lf_sharp = br.f(3)
            self.lf_delta_enabled = br.f(1)
            if self.lf_delta_enabled and br.f(1):
                for i in range(8):
                    if br.f(1):
                        self.lf_ref_deltas[i] = br.su(7)
                for i in range(2):
                    if br.f(1):
                        self.lf_mode_deltas[i] = br.su(7)
        # cdef
        self.cdef_damping, self.cdef_bits = 3, 0
        self.cdef_y = [(0, 0)]
        self.cdef_uv = [(0, 0)]
        self.cdef_on = bool(s["cdef"] and not self.coded_lossless
                            and not self.allow_intrabc)
        if self.cdef_on:
            self.cdef_damping = br.f(2) + 3
            self.cdef_bits = br.f(2)
            self.cdef_y, self.cdef_uv = [], []
            for _ in range(1 << self.cdef_bits):
                pri, sec = br.f(4), br.f(2)
                self.cdef_y.append((pri, sec + (sec == 3)))
                if not s["mono"]:
                    pri, sec = br.f(4), br.f(2)
                    self.cdef_uv.append((pri, sec + (sec == 3)))
                else:
                    self.cdef_uv.append((0, 0))
        # loop restoration
        nplanes = 1 if s["mono"] else 3
        self.lr_type = [RESTORE_NONE] * 3
        self.lr_size = [256, 256, 256]
        if s["restoration"] and not all_lossless and \
                not self.allow_intrabc:
            chroma = False
            for p in range(nplanes):
                self.lr_type[p] = REMAP_LR[br.f(2)]
                if p and self.lr_type[p] != RESTORE_NONE:
                    chroma = True
            if any(t != RESTORE_NONE for t in self.lr_type):
                if s["sb128"]:
                    shift = br.f(1) + 1
                else:
                    shift = br.f(1)
                    if shift:
                        shift += br.f(1)
                self.lr_size[0] = 256 >> (2 - shift)
                uv_shift = br.f(1) if (s["ssx"] and s["ssy"] and chroma) \
                    else 0
                self.lr_size[1] = self.lr_size[2] = self.lr_size[0] >> \
                    uv_shift
        # tx mode, reference mode, skip mode, warped motion, reduced tx set
        if self.coded_lossless:
            self.tx_mode_select = 0
        else:
            self.tx_mode_select = br.f(1)
        self.reference_select = 0 if intra else br.f(1)
        self.skip_mode_params(br)
        self.allow_warped = 0 if intra or error_res or not \
            s["warped_motion"] else br.f(1)
        self.reduced_tx_set = br.f(1)
        self.global_motion_params(br, prev)
        self.grain = None
        if s["film_grain"] and (show_frame or showable) and br.f(1):
            from .av1_grain import read_grain_params
            seed = br.f(16)
            if frame_type != INTER_FRAME or br.f(1):     # update_grain
                self.grain = read_grain_params(br, s["mono"], s["ssx"],
                                               s["ssy"], seed)
            else:
                idx = br.f(3)                # film_grain_params_ref_idx
                ref = self.slots[idx]
                if ref is None:
                    raise IOError(f"AV1: film grain parameters of an empty "
                                  f"slot ({self.name})")
                if ref[1] is not None:
                    self.grain = dict(ref[1], seed=seed)
        return True

    def rel_dist(self, a, b):
        """get_relative_dist (7.12.2... 5.9.x): a - b in order hints."""
        bits = self.seq["order_hint_bits"]
        if not bits:
            return 0
        diff = a - b
        m = 1 << (bits - 1)
        return (diff & (m - 1)) - (diff & m)

    def frame_size(self, br, override):
        """frame_size, superres_params and render_size (5.9.5-5.9.8)."""
        s = self.seq
        if override:
            self.up_w = br.f(s["wbits"]) + 1
            self.h = br.f(s["hbits"]) + 1
        else:
            self.up_w, self.h = s["max_w"], s["max_h"]
        self.superres_params(br)
        if br.f(1):
            br.f(16)
            br.f(16)

    def superres_params(self, br):
        """superres_params and compute_image_size: FrameWidth from
        UpscaledWidth (up_w)."""
        self.w = self.up_w
        self.sr_denom = SUPERRES_NUM
        if self.seq["superres"] and br.f(1):
            self.sr_denom = br.f(3) + 9     # SUPERRES_DENOM_MIN
            # libaom keeps FrameWidth at least Min(16, UpscaledWidth)
            self.w = max((self.up_w * SUPERRES_NUM + self.sr_denom // 2)
                         // self.sr_denom, min(16, self.up_w))
        self.mi_cols = 2 * ((self.w + 7) >> 3)
        self.mi_rows = 2 * ((self.h + 7) >> 3)

    def frame_size_with_refs(self, br):
        """frame_size_with_refs (5.9.7): a reference frame's size, or one
        coded here."""
        for i in range(7):
            if br.f(1):                                 # found_ref
                ref = self.saved[self.ref_idx[i]]
                self.up_w, self.h = ref["up_w"], ref["h"]
                self.superres_params(br)
                return
        self.frame_size(br, 1)

    def set_frame_refs(self, last, gold):
        """set_frame_refs (7.8): ref_frame_idx from LAST_FRAME's and
        GOLDEN_FRAME's slots and the slots' order hints."""
        ref = [-1] * 7
        ref[0], ref[GOLDEN_FRAME - 1] = last, gold
        used = [0] * 8
        used[last] = used[gold] = 1
        cur = 1 << (self.seq["order_hint_bits"] - 1)
        hint = [cur + self.rel_dist(self.saved[i]["order_hint"]
                                    if self.saved[i] else 0, self.order_hint)
                for i in range(8)]

        def pick(backward, latest):
            best = -1
            for i in range(8):
                h = hint[i]
                if used[i] or (h >= cur) != backward:
                    continue
                if best < 0 or (h >= hint[best] if latest
                                else h < hint[best]):
                    best = i
            return best
        r = pick(True, True)
        if r >= 0:
            ref[ALTREF_FRAME - 1], used[r] = r, 1
        r = pick(True, False)
        if r >= 0:
            ref[BWDREF_FRAME - 1], used[r] = r, 1
        r = pick(True, False)
        if r >= 0:
            ref[ALTREF2_FRAME - 1], used[r] = r, 1
        for f in (LAST2_FRAME, LAST3_FRAME, BWDREF_FRAME, ALTREF2_FRAME,
                  ALTREF_FRAME):
            if ref[f - 1] < 0:
                r = pick(False, True)
                if r >= 0:
                    ref[f - 1], used[r] = r, 1
        r = -1
        for i in range(8):
            if r < 0 or hint[i] < hint[r]:
                r = i
        self.ref_idx = [r if v < 0 else v for v in ref]

    def segmentation_params(self, br, prev):
        """segmentation_params (5.9.14): the features are those of the
        primary reference frame unless coded here."""
        self.seg_enabled = br.f(1)
        self.seg_update_map, self.seg_temporal = 1, 0
        self.seg_feat = [[None] * 8 for _ in range(8)]
        if self.seg_enabled:
            update_data = 1
            if prev is not None:
                self.seg_update_map = br.f(1)
                if self.seg_update_map:
                    self.seg_temporal = br.f(1)
                update_data = br.f(1)
                self.seg_feat = [list(f) for f in prev["seg_feat"]]
            if update_data:
                for i in range(8):
                    for j in range(8):
                        v = None
                        if br.f(1):
                            bits = SEG_FEATURE_BITS[j]
                            lim = SEG_FEATURE_MAX[j]
                            if SEG_FEATURE_SIGNED[j]:
                                v = max(-lim, min(lim, br.su(1 + bits)))
                            else:
                                v = max(0, min(lim, br.f(bits)))
                        self.seg_feat[i][j] = v
        self.seg_pre_skip, self.last_seg = 0, 0
        for i in range(8):
            for j in range(8):
                if self.seg_feat[i][j] is not None:
                    self.last_seg = i
                    if j >= 5:
                        self.seg_pre_skip = 1

    def skip_mode_params(self, br):
        """skip_mode_params (5.9.22): SkipModeFrame, the nearest forward
        and backward (or two forward) references."""
        self.skip_mode_present = 0
        if self.frame_is_intra or not self.reference_select or \
                not self.seq["order_hint_bits"]:
            return
        fwd = bwd = -1
        fwd_h = bwd_h = 0
        for i in range(7):
            h = self.order_hints[i + 1]
            dist = self.rel_dist(h, self.order_hint)
            if dist < 0:
                if fwd < 0 or self.rel_dist(h, fwd_h) > 0:
                    fwd, fwd_h = i, h
            elif dist > 0:
                if bwd < 0 or self.rel_dist(h, bwd_h) < 0:
                    bwd, bwd_h = i, h
        if fwd < 0:
            return
        if bwd < 0:
            bwd = -1
            for i in range(7):
                h = self.order_hints[i + 1]
                if self.rel_dist(h, fwd_h) < 0 and (
                        bwd < 0 or self.rel_dist(h, bwd_h) > 0):
                    bwd, bwd_h = i, h
            if bwd < 0:
                return
        self.skip_mode_frame = (1 + min(fwd, bwd), 1 + max(fwd, bwd))
        self.skip_mode_present = br.f(1)

    def global_motion_params(self, br, prev):
        """global_motion_params (5.9.24): each reference's warp against
        the primary reference frame's parameters."""
        ident = [0, 0, 1 << 16, 0, 0, 1 << 16]
        self.gm_type = [IDENTITY] * 8
        self.gm = [list(ident) for _ in range(8)]
        if self.frame_is_intra:
            return
        prev_gm = prev["gm"] if prev is not None else self.gm
        for ref in range(1, 8):
            typ = IDENTITY
            if br.f(1):
                if br.f(1):
                    typ = ROTZOOM
                else:
                    typ = TRANSLATION if br.f(1) else AFFINE
            self.gm_type[ref] = typ
            g = self.gm[ref]

            def param(idx):
                abs_bits, prec_bits = 12, 15
                if idx < 2:
                    if typ == TRANSLATION:
                        abs_bits = 9 - (1 - self.allow_hp)
                        prec_bits = 3 - (1 - self.allow_hp)
                    else:
                        abs_bits, prec_bits = 12, 6
                diff = 16 - prec_bits
                rnd = (1 << 16) if idx % 3 == 2 else 0
                sub = (1 << prec_bits) if idx % 3 == 2 else 0
                mx = 1 << abs_bits
                r = (prev_gm[ref][idx] >> diff) - sub
                g[idx] = (self.signed_subexp(br, -mx, mx + 1, r) << diff) \
                    + rnd
            if typ >= ROTZOOM:
                param(2)
                param(3)
                if typ == AFFINE:
                    param(4)
                    param(5)
                else:
                    g[4], g[5] = -g[3], g[2]
            if typ >= TRANSLATION:
                param(0)
                param(1)

    @staticmethod
    def signed_subexp(br, low, high, r):
        """decode_signed_subexp_with_ref (5.9.26-5.9.28), k = 3."""
        mx, r = high - low, r - low
        i = mk = 0
        while True:
            b2 = 3 + i - 1 if i else 3
            a = 1 << b2
            if mx <= mk + 3 * a:
                v = br.ns(mx - mk) + mk
                break
            if br.f(1):
                i += 1
                mk += a
            else:
                v = br.f(b2) + mk
                break

        def recenter(r_, v_):
            if v_ > 2 * r_:
                return v_
            return r_ - ((v_ + 1) >> 1) if v_ & 1 else r_ + (v_ >> 1)
        if (r << 1) <= mx:
            v = recenter(r, v)
        else:
            v = mx - 1 - recenter(mx - 1 - r, v)
        return v + low

    def _delta_q(self, br):
        return br.su(7) if br.f(1) else 0

    def tile_info(self, br):
        s = self.seq
        sb_shift = 5 if s["sb128"] else 4
        sb_cols = (self.mi_cols + (1 << sb_shift) - 1) >> sb_shift
        sb_rows = (self.mi_rows + (1 << sb_shift) - 1) >> sb_shift
        sb_size = sb_shift + 2
        max_w_sb = 4096 >> sb_size
        max_area_sb = (4096 * 2304) >> (2 * sb_size)

        def tile_log2(blk, target):
            k = 0
            while (blk << k) < target:
                k += 1
            return k
        min_log2_cols = tile_log2(max_w_sb, sb_cols)
        max_log2_cols = tile_log2(1, min(sb_cols, 64))
        max_log2_rows = tile_log2(1, min(sb_rows, 64))
        min_log2 = max(min_log2_cols, tile_log2(max_area_sb,
                                                sb_rows * sb_cols))
        cols, rows = [], []
        if br.f(1):
            cl = min_log2_cols
            while cl < max_log2_cols and br.f(1):
                cl += 1
            w_sb = (sb_cols + (1 << cl) - 1) >> cl
            cols = list(range(0, sb_cols, w_sb))
            rl = max(min_log2 - cl, 0)
            while rl < max_log2_rows and br.f(1):
                rl += 1
            h_sb = (sb_rows + (1 << rl) - 1) >> rl
            rows = list(range(0, sb_rows, h_sb))
            self.tile_cols_log2, self.tile_rows_log2 = cl, rl
        else:
            widest, start = 0, 0
            while start < sb_cols:
                cols.append(start)
                size = br.ns(min(sb_cols - start, max_w_sb)) + 1
                widest = max(widest, size)
                start += size
            if min_log2 > 0:
                area = (sb_rows * sb_cols) >> (min_log2 + 1)
            else:
                area = sb_rows * sb_cols
            max_h = max(area // widest, 1)
            start = 0
            while start < sb_rows:
                rows.append(start)
                start += br.ns(min(sb_rows - start, max_h)) + 1
            self.tile_cols_log2 = tile_log2(1, len(cols))
            self.tile_rows_log2 = tile_log2(1, len(rows))
        self.col_starts = [c << sb_shift for c in cols] + [self.mi_cols]
        self.row_starts = [r << sb_shift for r in rows] + [self.mi_rows]
        self.check_tile_widths()
        self.tile_size_bytes = 4
        self.context_update_tile_id = 0
        if self.tile_cols_log2 or self.tile_rows_log2:
            self.context_update_tile_id = br.f(self.tile_rows_log2
                                               + self.tile_cols_log2)
            self.tile_size_bytes = br.f(2) + 1

    def check_tile_widths(self):
        """libaom's av1_is_min_tile_width_satisfied: under superres each
        tile column but the last at least 128 coded pixels wide."""
        inner = [b - a for a, b in zip(self.col_starts[:-2],
                                       self.col_starts[1:-1])]
        if inner and self.up_w != self.w and min(inner) * 4 < 128:
            raise IOError(f"AV1: a tile column under 128 coded pixels "
                          f"with superres, which libaom refuses "
                          f"({self.name})")

    def qidx(self, sid, current):
        """get_qidx: the segment's qindex; `current` is CurrentQIndex, or
        None to ignore delta q."""
        data = self.seg_feat[sid][0] if self.seg_enabled else None
        if data is not None:
            q = (current if current is not None and self.delta_q_present
                 else self.base_q) + data
            return max(0, min(255, q))
        if current is not None and self.delta_q_present:
            return current
        return self.base_q

    # ---- tiles ------------------------------------------------------------
    def tile_group(self, data, pos, end):
        ntiles = (len(self.col_starts) - 1) * (len(self.row_starts) - 1)
        br = BitReader(data, pos)
        start, last = 0, ntiles - 1
        if ntiles > 1 and br.f(1):
            bits = self.tile_cols_log2 + self.tile_rows_log2
            start, last = br.f(bits), br.f(bits)
        br.byte_align()
        pos = br.bitpos >> 3
        if start == 0:
            self.begin_frame()
        ncols = len(self.col_starts) - 1
        for t in range(start, last + 1):
            if t == last:
                size = end - pos
            else:
                size = int.from_bytes(data[pos:pos + self.tile_size_bytes],
                                      "little") + 1
                pos += self.tile_size_bytes
            if pos + size > end:
                raise IOError(f"AV1: truncated tile ({self.name})")
            tr, tc = divmod(t, ncols)
            sd = SymbolDecoder(data, pos, size, self.disable_cdf_update)
            td = TileDecoder(self, sd, self.row_starts[tr],
                             self.row_starts[tr + 1], self.col_starts[tc],
                             self.col_starts[tc + 1])
            td.decode()
            if t == self.context_update_tile_id:
                self.end_cdf = td.cdf
            pos += size
        if last == ntiles - 1:
            self.frame_done = True

    def begin_frame(self):
        s = self.seq
        self.nplanes = 1 if s["mono"] else 3
        self.ssx, self.ssy = s["ssx"], s["ssy"]
        self.bd = s["bd"]
        self.mi = [[None] * self.mi_cols for _ in range(self.mi_rows)]
        self.inter_tx = [[0] * self.mi_cols for _ in range(self.mi_rows)]
        self.cdef_idx = {}
        self.records = []
        # loop filter transform sizes per plane, in 4 x 4 units of the plane
        self.lf_tx = []
        for p in range(self.nplanes):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            self.lf_tx.append(np.zeros(
                ((self.mi_rows + sy) >> sy, (self.mi_cols + sx) >> sx),
                np.int8))
        self.lr_units = [{} for _ in range(3)]
        self.end_cdf = None
        # PrevSegmentIds (load_previous_segment_ids)
        self.prev_seg = np.zeros((self.mi_rows, self.mi_cols), np.int8)
        if self.primary_ref != PRIMARY_REF_NONE and self.seg_enabled:
            prev = self.saved[self.ref_idx[self.primary_ref]]
            if prev["mi_rows"] == self.mi_rows and \
                    prev["mi_cols"] == self.mi_cols:
                self.prev_seg = prev["seg"]
        self.motion_field = None
        if self.use_ref_frame_mvs:
            from .av1_mv import motion_field_estimation
            self.motion_field = motion_field_estimation(self)


class TileDecoder:
    """The tile syntax, read through `sd`. An encoder drives the same
    parse (av1_enc.TileEncoder): `parts` and `plans` then hold the
    partition of each node and the mode info of each block that it has
    chosen, `cplan` the levels of the transform block at hand, and each
    read is handed the value to write; the hooks `before_coeffs` and
    `after_coeffs` let it predict and reconstruct in decode order."""

    parts = plans = cplan = lr_plan = None

    def __init__(self, dec, sd, r0, r1, c0, c1):
        self.d = dec
        self.sd = sd
        self.r0, self.r1, self.c0, self.c1 = r0, r1, c0, c1
        self.cdf = copy_cdfs(dec.frame_cdf)
        np_ = dec.nplanes
        cols = dec.mi_cols + 32
        rows = dec.mi_rows + 32
        self.above_level = [[0] * cols for _ in range(np_)]
        self.above_dc = [[0] * cols for _ in range(np_)]
        self.left_level = [[0] * rows for _ in range(np_)]
        self.left_dc = [[0] * rows for _ in range(np_)]
        self.delta_lf = [0, 0, 0, 0]
        self.ref_sgr = [list(SGR_MID) for _ in range(3)]
        self.ref_wiener = [[list(WIENER_MID), list(WIENER_MID)]
                           for _ in range(3)]
        self.current_q = dec.base_q
        self.sb4 = 32 if dec.seq["sb128"] else 16
        self.tx_types = {}           # luma TxTypes by (y4, x4)
        self.above_seg_pred = [0] * cols
        self.left_seg_pred = [0] * rows

    def decode(self):
        d = self.d
        sb4 = self.sb4
        bsize = B128X128 if sb4 == 32 else B64X64
        for r in range(self.r0, self.r1, sb4):
            for p in range(d.nplanes):
                ll, ld = self.left_level[p], self.left_dc[p]
                for i in range(len(ll)):
                    ll[i] = 0
                    ld[i] = 0
            self.left_seg_pred = [0] * len(self.left_seg_pred)
            for c in range(self.c0, self.c1, sb4):
                self.superblock(r, c, bsize)

    def superblock(self, r, c, bsize):
        d = self.d
        self.read_deltas = d.delta_q_present
        for dr in (0, 16) if self.sb4 == 32 else (0,):
            for dc in (0, 16) if self.sb4 == 32 else (0,):
                d.cdef_idx[(r + dr, c + dc)] = -1
        self.clear_decoded(r, c)
        self.read_lr(r, c, bsize)
        self.partition(r, c, bsize)

    # BlockDecoded, per plane, indexed [y + 1][x + 1] in plane 4 x 4 units
    def clear_decoded(self, r, c):
        d = self.d
        sb4 = self.sb4
        self.decoded = []
        self.sb_r, self.sb_c = r, c
        for p in range(d.nplanes):
            sx, sy = (d.ssx, d.ssy) if p else (0, 0)
            w4 = (self.c1 - c) >> sx
            h4 = (self.r1 - r) >> sy
            n_y, n_x = (sb4 >> sy) + 2, (sb4 >> sx) + 2
            g = [[0] * (n_x + 1) for _ in range(n_y + 1)]
            for x in range(-1, n_x - 1):
                g[0][x + 1] = 1 if x < w4 else 0
            for y in range(0, n_y - 1):
                g[y + 1][0] = 1 if y < h4 else 0
            g[(sb4 >> sy) + 1][0] = 0
            self.decoded.append(g)

    def inside(self, r, c):
        return self.c0 <= c < self.c1 and self.r0 <= r < self.r1

    # ---- loop restoration units -------------------------------------------
    def read_lr(self, r, c, bsize):
        d = self.d
        if d.allow_intrabc:
            return
        w, h = BW4[bsize], BH4[bsize]
        for p in range(d.nplanes):
            if d.lr_type[p] == RESTORE_NONE:
                continue
            sx, sy = (d.ssx, d.ssy) if p else (0, 0)
            size = d.lr_size[p]
            rows = max((((d.h + sy) >> sy) + (size >> 1)) // size, 1)
            cols = max((((d.up_w + sx) >> sx) + (size >> 1)) // size, 1)
            r_start = (r * (4 >> sy) + size - 1) // size
            r_end = min(rows, ((r + h) * (4 >> sy) + size - 1) // size)
            # columns count in superres-upscaled units
            num, den = (4 >> sx) * d.sr_denom, size * SUPERRES_NUM
            c_start = (c * num + den - 1) // den
            c_end = min(cols, ((c + w) * num + den - 1) // den)
            for ur in range(r_start, r_end):
                for uc in range(c_start, c_end):
                    self.read_lr_unit(p, ur, uc)

    def read_lr_unit(self, p, ur, uc):
        """One restoration unit; an encoder names the unit to write in
        `lr_plan` {(plane, unit row, unit column): unit}."""
        d, sd, cdf = self.d, self.sd, self.cdf
        t = d.lr_type[p]
        want = None if self.lr_plan is None else self.lr_plan[(p, ur, uc)]
        wt = None if want is None else want[0]
        if t == RESTORE_WIENER:
            rtype = RESTORE_WIENER if sd.symbol(
                cdf["USE_WIENER"], None if wt is None else int(wt > 0)) \
                else 0
        elif t == RESTORE_SGRPROJ:
            rtype = RESTORE_SGRPROJ if sd.symbol(
                cdf["USE_SGRPROJ"], None if wt is None else int(wt > 0)) \
                else 0
        else:
            rtype = sd.symbol(cdf["RESTORATION_TYPE"], wt)
        unit = (rtype,)
        if rtype == RESTORE_WIENER:
            coeffs = []
            for pas in range(2):
                first = 1 if p else 0
                taps = [0, 0, 0]
                for j in range(first, 3):
                    v = self.subexp_ref(WIENER_MIN[j], WIENER_MAX[j] + 1,
                                        WIENER_K[j],
                                        self.ref_wiener[p][pas][j],
                                        None if want is None
                                        else want[1][pas][j])
                    taps[j] = v
                    self.ref_wiener[p][pas][j] = v
                coeffs.append(taps)
            unit = (rtype, coeffs)
        elif rtype == RESTORE_SGRPROJ:
            s = sd.literal(4, None if want is None else want[1])
            xqd = [0, 0]
            for i in range(2):
                radius = T.SGR_PARAMS[s][i * 2]
                lo, hi = SGR_MIN[i], SGR_MAX[i]
                if radius:
                    v = self.subexp_ref(lo, hi + 1, 4, self.ref_sgr[p][i],
                                        None if want is None
                                        else want[2][i])
                else:
                    v = 0
                    if i == 1:
                        v = max(lo, min(hi, 128 - self.ref_sgr[p][0]))
                xqd[i] = v
                self.ref_sgr[p][i] = v
            unit = (rtype, s, xqd)
        d.lr_units[p][(ur, uc)] = unit

    def subexp_ref(self, low, high, k, r, want=None):
        """decode_signed_subexp_with_ref_bool; `want` the value an
        encoder writes."""
        mx = high - low
        r -= low
        sd = self.sd

        def recenter(r_, v_):
            if v_ > 2 * r_:
                return v_
            if v_ & 1:
                return r_ - ((v_ + 1) >> 1)
            return r_ + (v_ >> 1)

        def unrecenter(r_, x):
            if x > 2 * r_:
                return x
            return (x - r_) << 1 if x >= r_ else ((r_ - x) << 1) - 1
        code = None
        if want is not None:
            x = want - low
            code = unrecenter(r, x) if (r << 1) <= mx else \
                unrecenter(mx - 1 - r, mx - 1 - x)
        i, mk = 0, 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if mx <= mk + 3 * a:
                v = sd.ns(mx - mk, None if code is None else code - mk) + mk
                break
            if sd.literal(1, None if code is None
                          else int(code >= mk + a)):
                i += 1
                mk += a
            else:
                v = sd.literal(b2, None if code is None else code - mk) + mk
                break
        if (r << 1) <= mx:
            v = recenter(r, v)
        else:
            v = mx - 1 - recenter(mx - 1 - r, v)
        return v + low

    # ---- partitions -------------------------------------------------------
    def partition(self, r, c, bsize):
        d = self.d
        if r >= d.mi_rows or c >= d.mi_cols:
            return
        n4 = BW4[bsize]
        half = n4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < d.mi_rows
        has_cols = (c + half) < d.mi_cols
        part = self.read_partition(r, c, bsize)
        w, h = 4 * n4, 4 * n4
        sub = {0: (w, h), 1: (w, h // 2), 2: (w // 2, h), 3: (w // 2, h // 2),
               4: (w, h // 2), 5: (w, h // 2), 6: (w // 2, h),
               7: (w // 2, h), 8: (w, h // 4), 9: (w // 4, h)}[part]
        sub = _BSIZE[(sub[0] // 4, sub[1] // 4)]
        split = _BSIZE[(n4 // 2, n4 // 2)] if n4 > 1 else bsize
        blk = self.block
        if part == 0:
            blk(r, c, sub)
        elif part == 1:
            blk(r, c, sub)
            if has_rows:
                blk(r + half, c, sub)
        elif part == 2:
            blk(r, c, sub)
            if has_cols:
                blk(r, c + half, sub)
        elif part == 3:
            self.partition(r, c, sub)
            self.partition(r, c + half, sub)
            self.partition(r + half, c, sub)
            self.partition(r + half, c + half, sub)
        elif part == 4:
            blk(r, c, split)
            blk(r, c + half, split)
            blk(r + half, c, sub)
        elif part == 5:
            blk(r, c, sub)
            blk(r + half, c, split)
            blk(r + half, c + half, split)
        elif part == 6:
            blk(r, c, split)
            blk(r + half, c, split)
            blk(r, c + half, sub)
        elif part == 7:
            blk(r, c, sub)
            blk(r, c + half, split)
            blk(r + half, c + half, split)
        elif part == 8:
            for k in range(4):
                if k < 3 or r + quarter * 3 < d.mi_rows:
                    blk(r + quarter * k, c, sub)
        else:
            for k in range(4):
                if k < 3 or c + quarter * 3 < d.mi_cols:
                    blk(r, c + quarter * k, sub)

    def read_partition(self, r, c, bsize):
        """The partition of the node at (r, c): its symbol, or what the
        frame's edges leave of it."""
        d = self.d
        half = BW4[bsize] >> 1
        has_rows = (r + half) < d.mi_rows
        has_cols = (c + half) < d.mi_cols
        if bsize < B8X8:
            part = 0
        else:
            bsl = BLOG2W[bsize]
            above = left = 0
            if self.inside(r - 1, c):
                above = BLOG2W[d.mi[r - 1][c].size] < bsl
            if self.inside(r, c - 1):
                left = BLOG2H[d.mi[r][c - 1].size] < bsl
            cdf = self.cdf["PARTITION"][(bsl - 1) * 4 + left * 2 + above]
            want = None if self.parts is None else self.parts[(r, c, bsize)]
            if has_rows and has_cols:
                part = self.sd.symbol(cdf, want)
            elif has_cols or has_rows:
                def prob(e):
                    return cdf[e] - (cdf[e - 1] if e else 0)
                # the probability of SPLIT gathered from the CDF as
                # libaom gathers it
                if not has_cols:
                    elems = [1, 3, 4, 5, 6]
                    if bsize != B128X128:
                        elems.append(8)
                else:
                    elems = [2, 3, 4, 6, 7]
                    if bsize != B128X128:
                        elems.append(9)
                psum = sum(prob(e) for e in elems)
                bit = self.sd.symbol([32768 - psum, 32768, 0],
                                     None if want is None else int(want == 3))
                part = 3 if bit else (1 if has_cols else 2)
            else:
                part = 3
        return part

    # ---- blocks -------------------------------------------------------------
    def block(self, r, c, bsize):
        d, sd, cdf = self.d, self.sd, self.cdf
        p = None if self.plans is None else self.plans[(r, c, bsize)]
        b = Block()
        b.row, b.col, b.size = r, c, bsize
        bw4, bh4 = BW4[bsize], BH4[bsize]
        has_chroma = self.set_avail(b)
        avail_u, avail_l = b.avail[:2]
        b.var_tx = None
        above = d.mi[r - 1][c] if avail_u else None
        left = d.mi[r][c - 1] if avail_l else None
        b.ref = (INTRA_FRAME, NONE_FRAME)
        b.mv = ((0, 0), (0, 0))
        b.skip_mode = b.interintra = b.comp_group = b.ref_mv_idx = 0
        b.motion_mode = SIMPLE
        b.comp_type = COMPOUND_AVERAGE
        b.comp_idx = 1
        b.interp = (EIGHTTAP, EIGHTTAP)
        b.warp = None
        b.pal_size = (0, 0)
        b.pal_colors = ((), ())
        b.filter_mode = -1
        b.angle_y = b.angle_uv = 0
        b.cfl_u = b.cfl_v = 0
        b.use_intrabc = 0
        if d.frame_is_intra:
            self.intra_frame_mode_info(b, r, c, above, left, p)
        else:
            self.inter_frame_mode_info(b, r, c, above, left)
        # palette_tokens
        b.color_map_y = b.color_map_uv = None
        if b.pal_size[0] or b.pal_size[1]:
            self.palette_tokens(b, r, c)
        # read_block_tx_size
        self.read_tx_size(b, r, c, above, left)
        # store mode info
        rows = d.mi
        rmax = min(r + bh4, d.mi_rows)
        cmax = min(c + bw4, d.mi_cols)
        for y in range(r, rmax):
            row = rows[y]
            for x in range(c, cmax):
                row[x] = b
        if b.var_tx is None:
            for y in range(r, rmax):
                row = d.inter_tx[y]
                for x in range(c, cmax):
                    row[x] = b.tx_size
        if b.skip:
            self.reset_block_context(b)
        self.residual(b)

    def intra_frame_mode_info(self, b, r, c, above, left, p):
        """intra_frame_mode_info (5.11.7)."""
        d, sd, cdf = self.d, self.sd, self.cdf
        avail_u, avail_l = b.avail[:2]
        b.seg = 0
        b.skip = 0
        if d.seg_pre_skip:
            self.intra_segment_id(b, r, c, avail_u, avail_l)
        if d.seg_pre_skip and d.seg_enabled and \
                d.seg_feat[b.seg][6] is not None:
            b.skip = 1
        else:
            ctx = (above.skip if above else 0) + (left.skip if left else 0)
            b.skip = sd.symbol(cdf["SKIP"][ctx], p and p.skip)
        if not d.seg_pre_skip:
            self.intra_segment_id(b, r, c, avail_u, avail_l)
        self.block_deltas(b)
        b.use_intrabc = sd.symbol(cdf["INTRABC"]) if d.allow_intrabc else 0
        if b.use_intrabc:
            b.is_inter = 1
            b.y_mode = b.uv_mode = DC_PRED
            from .av1_mv import intrabc_mv
            b.mv = (intrabc_mv(self, b, r, c), (0, 0))
        else:
            b.is_inter = 0
            self.intra_modes(b, above, left, p,
                             self.y_mode_cdf(above, left))

    def block_deltas(self, b):
        """Lossless, cdef_idx, delta q and delta lf of a block, after its
        skip and segment id."""
        d = self.d
        b.lossless = d.lossless[b.seg]
        self.read_cdef(b, b.row, b.col, b.size)
        sb_size = B128X128 if self.sb4 == 32 else B64X64
        if self.read_deltas and not (b.size == sb_size and b.skip):
            self.read_delta_q()
            self.read_delta_lf()
        self.read_deltas = 0
        b.qindex = self.current_q
        b.delta_lf = tuple(self.delta_lf)

    def intra_modes(self, b, above, left, p, y_cdf):
        """The luma and chroma modes of an intra block (from its y_mode
        read under `y_cdf`), their angle deltas, CFL alphas, palettes
        and filter intra."""
        d, sd, cdf = self.d, self.sd, self.cdf
        bsize = b.size
        bw4, bh4 = BW4[bsize], BH4[bsize]
        b.y_mode = sd.symbol(y_cdf, p and p.y_mode)
        if bsize >= B8X8 and V_PRED <= b.y_mode <= D67:
            b.angle_y = sd.symbol(cdf["ANGLE_DELTA"][b.y_mode - 1],
                                  p and p.angle_y + 3) - 3
        b.uv_mode = DC_PRED
        if self.has_chroma:
            b.uv_mode = sd.symbol(self.uv_mode_cdf(b), p and p.uv_mode)
            if b.uv_mode == UV_CFL:
                self.read_cfl(b, p)
            if bsize >= B8X8 and V_PRED <= b.uv_mode <= D67:
                b.angle_uv = sd.symbol(
                    cdf["ANGLE_DELTA"][b.uv_mode - 1],
                    p and p.angle_uv + 3) - 3
        if bsize >= B8X8 and bw4 <= 16 and bh4 <= 16 and d.sct:
            self.palette_mode_info(b, b.row, b.col, above, left)
        if d.seq["filter_intra"] and b.y_mode == DC_PRED and \
                b.pal_size[0] == 0 and max(bw4, bh4) <= 8:
            if sd.symbol(cdf["USE_FILTER_INTRA"][bsize],
                         p and int(p.filter_mode >= 0)):
                b.filter_mode = sd.symbol(cdf["FILTER_INTRA_MODE"],
                                          p and p.filter_mode)

    # ---- inter frames (5.11.18 and after) -----------------------------------
    def seg_active(self, b, feature):
        d = self.d
        return d.seg_enabled and d.seg_feat[b.seg][feature] is not None

    def inter_frame_mode_info(self, b, r, c, above, left):
        """inter_frame_mode_info (5.11.18)."""
        d, sd, cdf = self.d, self.sd, self.cdf
        self.lref = left.ref if left else (INTRA_FRAME, NONE_FRAME)
        self.aref = above.ref if above else (INTRA_FRAME, NONE_FRAME)
        self.above_b, self.left_b = above, left
        b.skip = 0
        b.seg = 0
        self.inter_segment_id(b, r, c, True)
        # read_skip_mode
        if not (self.seg_active(b, 6) or self.seg_active(b, 5) or
                self.seg_active(b, 7)) and d.skip_mode_present and \
                BW4[b.size] >= 2 and BH4[b.size] >= 2:
            ctx = (above.skip_mode if above else 0) + \
                (left.skip_mode if left else 0)
            b.skip_mode = sd.symbol(cdf["SKIP_MODE"][ctx])
        if b.skip_mode:
            b.skip = 1
        elif d.seg_pre_skip and self.seg_active(b, 6):
            b.skip = 1
        else:
            ctx = (above.skip if above else 0) + (left.skip if left else 0)
            b.skip = sd.symbol(cdf["SKIP"][ctx])
        if not d.seg_pre_skip:
            self.inter_segment_id(b, r, c, False)
        self.block_deltas(b)
        # read_is_inter
        if b.skip_mode:
            b.is_inter = 1
        elif self.seg_active(b, 5):
            b.is_inter = int(d.seg_feat[b.seg][5] != INTRA_FRAME)
        elif self.seg_active(b, 7):
            b.is_inter = 1
        else:
            li = self.lref[0] <= INTRA_FRAME
            ai = self.aref[0] <= INTRA_FRAME
            if above and left:
                ctx = 3 if li and ai else int(li or ai)
            elif above or left:
                ctx = 2 * (ai if above else li)
            else:
                ctx = 0
            b.is_inter = sd.symbol(cdf["IS_INTER"][ctx])
        if b.is_inter:
            self.inter_block_mode_info(b)
        else:
            self.intra_modes(b, above, left, None,
                             cdf["Y_MODE"][SIZE_GROUP[b.size]])

    def inter_segment_id(self, b, r, c, pre_skip):
        """inter_segment_id (5.11.19) with its prediction from
        PrevSegmentIds."""
        d = self.d
        if not d.seg_enabled:
            b.seg = 0
            return
        bw4, bh4 = BW4[b.size], BH4[b.size]
        pred = int(d.prev_seg[r:r + bh4, c:c + bw4].min())
        if not d.seg_update_map:
            b.seg = pred
            return
        if pre_skip and not d.seg_pre_skip:
            b.seg = 0
            return
        if not pre_skip and b.skip:
            flag = 0
            self.intra_segment_id(b, r, c, *b.avail[:2])
        elif d.seg_temporal:
            ctx = self.left_seg_pred[r] + self.above_seg_pred[c]
            flag = self.sd.symbol(self.cdf["SEGMENT_ID_PREDICTED"][ctx])
            if flag:
                b.seg = pred
            else:
                self.intra_segment_id(b, r, c, *b.avail[:2])
        else:
            self.intra_segment_id(b, r, c, *b.avail[:2])
            return
        for i in range(c, c + bw4):
            self.above_seg_pred[i] = flag
        for i in range(r, r + bh4):
            self.left_seg_pred[i] = flag

    def count_refs(self, f):
        n = 0
        if self.above_b is not None:
            n += (self.aref[0] == f) + (self.aref[1] == f)
        if self.left_b is not None:
            n += (self.lref[0] == f) + (self.lref[1] == f)
        return n

    def ref_ctx(self, a, b_):
        """ref_count_ctx of the counts of the references in `a` and in
        `b_`."""
        n0 = sum(self.count_refs(f) for f in a)
        n1 = sum(self.count_refs(f) for f in b_)
        return 0 if n0 < n1 else 1 if n0 == n1 else 2

    def read_ref_frames(self, b):
        """read_ref_frames (5.11.25) with the contexts of 8.3.2."""
        d, sd, cdf = self.d, self.sd, self.cdf
        if b.skip_mode:
            b.ref = d.skip_mode_frame
            return
        if self.seg_active(b, 5):
            b.ref = (d.seg_feat[b.seg][5], NONE_FRAME)
            return
        if self.seg_active(b, 6) or self.seg_active(b, 7):
            b.ref = (LAST_FRAME, NONE_FRAME)
            return
        ab, lb = self.above_b, self.left_b
        a0, a1 = self.aref
        l0, l1 = self.lref
        a_intra, l_intra = a0 <= INTRA_FRAME, l0 <= INTRA_FRAME
        a_single, l_single = a1 <= INTRA_FRAME, l1 <= INTRA_FRAME
        comp = 0
        if d.reference_select and min(BW4[b.size], BH4[b.size]) >= 2:
            def back(f):
                return BWDREF_FRAME <= f <= ALTREF_FRAME
            if ab and lb:
                if a_single and l_single:
                    ctx = back(a0) ^ back(l0)
                elif a_single:
                    ctx = 2 + int(back(a0) or a_intra)
                elif l_single:
                    ctx = 2 + int(back(l0) or l_intra)
                else:
                    ctx = 4
            elif ab:
                ctx = int(back(a0)) if a_single else 3
            elif lb:
                ctx = int(back(l0)) if l_single else 3
            else:
                ctx = 1
            comp = sd.symbol(cdf["COMP_MODE"][ctx])
        fwd4 = (LAST_FRAME, LAST2_FRAME, LAST3_FRAME, GOLDEN_FRAME)
        bwd3 = (BWDREF_FRAME, ALTREF2_FRAME, ALTREF_FRAME)
        if comp:
            def same(x, y):
                return (x >= BWDREF_FRAME) == (y >= BWDREF_FRAME)
            a_comp = ab is not None and not a_intra and not a_single
            l_comp = lb is not None and not l_intra and not l_single
            a_uni = a_comp and same(a0, a1)
            l_uni = l_comp and same(l0, l1)
            if ab and not a_intra and lb and not l_intra:
                sd_ = int(same(a0, l0))
                if not a_comp and not l_comp:
                    ctx = 1 + 2 * sd_
                elif not a_comp:
                    ctx = 3 + sd_ if l_uni else 1
                elif not l_comp:
                    ctx = 3 + sd_ if a_uni else 1
                elif not a_uni and not l_uni:
                    ctx = 0
                elif not a_uni or not l_uni:
                    ctx = 2
                else:
                    ctx = 3 + int((a0 == BWDREF_FRAME) ==
                                  (l0 == BWDREF_FRAME))
            elif ab and lb:
                if a_comp:
                    ctx = 1 + 2 * a_uni
                elif l_comp:
                    ctx = 1 + 2 * l_uni
                else:
                    ctx = 2
            elif a_comp:
                ctx = 4 * a_uni
            elif l_comp:
                ctx = 4 * l_uni
            else:
                ctx = 2
            if sd.symbol(cdf["COMP_REF_TYPE"][ctx]) == 0:   # unidirectional
                u = cdf["UNI_COMP_REF"]
                if sd.symbol(u[self.ref_ctx(fwd4, bwd3)][0]):
                    b.ref = (BWDREF_FRAME, ALTREF_FRAME)
                elif sd.symbol(u[self.ref_ctx(
                        (LAST2_FRAME,), (LAST3_FRAME, GOLDEN_FRAME))][1]):
                    b.ref = (LAST_FRAME, GOLDEN_FRAME) if sd.symbol(u[
                        self.ref_ctx((LAST3_FRAME,), (GOLDEN_FRAME,))][2]) \
                        else (LAST_FRAME, LAST3_FRAME)
                else:
                    b.ref = (LAST_FRAME, LAST2_FRAME)
                return
            cr, cb = cdf["COMP_REF"], cdf["COMP_BWDREF"]
            if sd.symbol(cr[self.ref_ctx((LAST_FRAME, LAST2_FRAME),
                                         (LAST3_FRAME, GOLDEN_FRAME))][0]):
                r0 = GOLDEN_FRAME if sd.symbol(cr[self.ref_ctx(
                    (LAST3_FRAME,), (GOLDEN_FRAME,))][2]) else LAST3_FRAME
            else:
                r0 = LAST2_FRAME if sd.symbol(cr[self.ref_ctx(
                    (LAST_FRAME,), (LAST2_FRAME,))][1]) else LAST_FRAME
            if sd.symbol(cb[self.ref_ctx((BWDREF_FRAME, ALTREF2_FRAME),
                                         (ALTREF_FRAME,))][0]):
                r1 = ALTREF_FRAME
            else:
                r1 = ALTREF2_FRAME if sd.symbol(cb[self.ref_ctx(
                    (BWDREF_FRAME,), (ALTREF2_FRAME,))][1]) else BWDREF_FRAME
            b.ref = (r0, r1)
            return
        s_ = cdf["SINGLE_REF"]
        if sd.symbol(s_[self.ref_ctx(fwd4, bwd3)][0]):
            if sd.symbol(s_[self.ref_ctx((BWDREF_FRAME, ALTREF2_FRAME),
                                         (ALTREF_FRAME,))][1]):
                r0 = ALTREF_FRAME
            else:
                r0 = ALTREF2_FRAME if sd.symbol(s_[self.ref_ctx(
                    (BWDREF_FRAME,), (ALTREF2_FRAME,))][5]) else BWDREF_FRAME
        elif sd.symbol(s_[self.ref_ctx((LAST_FRAME, LAST2_FRAME),
                                       (LAST3_FRAME, GOLDEN_FRAME))][2]):
            r0 = GOLDEN_FRAME if sd.symbol(s_[self.ref_ctx(
                (LAST3_FRAME,), (GOLDEN_FRAME,))][4]) else LAST3_FRAME
        else:
            r0 = LAST2_FRAME if sd.symbol(s_[self.ref_ctx(
                (LAST_FRAME,), (LAST2_FRAME,))][3]) else LAST_FRAME
        b.ref = (r0, NONE_FRAME)

    def inter_block_mode_info(self, b):
        """inter_block_mode_info (5.11.23): references, mode, DRL index,
        vectors, inter-intra, motion mode, compound type and filters."""
        from .av1_mv import (find_mv_stack, has_overlappable_candidates,
                             find_warp_samples, read_mv, is_scaled)
        d, sd, cdf = self.d, self.sd, self.cdf
        self.read_ref_frames(b)
        comp = b.ref[1] > INTRA_FRAME
        st = find_mv_stack(self, b, comp)
        if b.skip_mode:
            b.y_mode = NEAREST_NEARESTMV
        elif self.seg_active(b, 6) or self.seg_active(b, 7):
            b.y_mode = GLOBALMV
        elif comp:
            ctx = COMPOUND_MODE_CTX_MAP[st.ref_mv_ctx >> 1][
                min(st.new_mv_ctx, 4)]
            b.y_mode = NEAREST_NEARESTMV + sd.symbol(
                cdf["COMPOUND_MODE"][ctx])
        elif sd.symbol(cdf["NEW_MV"][st.new_mv_ctx]) == 0:
            b.y_mode = NEWMV
        elif sd.symbol(cdf["ZERO_MV"][st.zero_mv_ctx]) == 0:
            b.y_mode = GLOBALMV
        else:
            b.y_mode = NEARESTMV if sd.symbol(
                cdf["REF_MV"][st.ref_mv_ctx]) == 0 else NEARMV
        idx = 0
        if b.y_mode in (NEWMV, NEW_NEWMV):
            start = 0
        elif b.y_mode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV):
            start = idx = 1
        else:
            start = None
        if start is not None:
            for i in range(start, start + 2):
                if st.num > i + 1:
                    if sd.symbol(cdf["DRL_MODE"][st.drl_ctx(i)]) == 0:
                        idx = i
                        break
                    idx = i + 1
        b.ref_mv_idx = idx
        # assign_mv
        mvs = []
        for i in range(1 + comp):
            mode = _single_mode(b.y_mode, i)
            if mode == GLOBALMV:
                pred = st.global_mvs[i]
            else:
                pos = 0 if mode == NEARESTMV else idx
                if mode == NEWMV and st.num <= 1:
                    pos = 0
                pred = st.stack[pos][i]
            if mode == NEWMV:
                dr, dc = read_mv(self, 0)
                pred = (pred[0] + dr, pred[1] + dc)
            mvs.append(pred)
        b.mv = (mvs[0], mvs[1] if comp else (0, 0))
        # read_interintra_mode
        s = d.seq
        if not b.skip_mode and s["interintra"] and not comp and \
                B8X8 <= b.size <= 9:
            g = SIZE_GROUP[b.size]
            b.interintra = sd.symbol(cdf["INTERINTRA"][g])
            if b.interintra:
                b.ii_mode = sd.symbol(cdf["INTERINTRA_MODE"][g])
                b.ref = (b.ref[0], INTRA_FRAME)
                b.wedge_ii = sd.symbol(cdf["WEDGE_INTERINTRA"][b.size])
                if b.wedge_ii:
                    b.wedge_index = sd.symbol(cdf["WEDGE_INDEX"][b.size])
                    b.wedge_sign = 0
        # read_motion_mode
        bw4, bh4 = BW4[b.size], BH4[b.size]
        b.motion_mode = SIMPLE
        if not b.skip_mode and d.motion_switchable and \
                min(bw4, bh4) >= 2 and not (
                    not d.force_imv and b.y_mode in (GLOBALMV,
                                                     GLOBAL_GLOBALMV) and
                    d.gm_type[b.ref[0]] > TRANSLATION) and not comp and \
                b.ref[1] != INTRA_FRAME and \
                has_overlappable_candidates(self, b):
            samples = find_warp_samples(self, b)
            if d.force_imv or not samples or not d.allow_warped or \
                    is_scaled(d, b.ref[0]):
                b.motion_mode = sd.symbol(cdf["USE_OBMC"][b.size])
            else:
                b.motion_mode = sd.symbol(cdf["MOTION_MODE"][b.size])
            if b.motion_mode == LOCALWARP:
                b.warp = samples
        # read_compound_type
        if b.skip_mode:
            b.comp_type = COMPOUND_AVERAGE
        elif comp:
            n = WEDGE_BITS[b.size]
            if s["masked"]:
                ctx = 0
                for nb, (r0, r1) in ((self.above_b, self.aref),
                                     (self.left_b, self.lref)):
                    if nb is None:
                        continue
                    if r1 > INTRA_FRAME:
                        ctx += nb.comp_group
                    elif r0 == ALTREF_FRAME:
                        ctx += 3
                b.comp_group = sd.symbol(cdf["COMP_GROUP_IDX"][min(5, ctx)])
            if b.comp_group == 0:
                b.comp_type = COMPOUND_AVERAGE
                if s["jnt_comp"]:
                    fwd = abs(d.rel_dist(d.order_hints[b.ref[0]],
                                         d.order_hint))
                    bck = abs(d.rel_dist(d.order_hints[b.ref[1]],
                                         d.order_hint))
                    ctx = 3 if fwd == bck else 0
                    for nb, (r0, r1) in ((self.above_b, self.aref),
                                         (self.left_b, self.lref)):
                        if nb is None:
                            continue
                        if r1 > INTRA_FRAME:
                            ctx += nb.comp_idx
                        elif r0 == ALTREF_FRAME:
                            ctx += 1
                    b.comp_idx = sd.symbol(cdf["COMPOUND_IDX"][ctx])
                    b.comp_type = COMPOUND_AVERAGE if b.comp_idx else \
                        COMPOUND_DISTANCE
            elif n == 0:
                b.comp_type = COMPOUND_DIFFWTD
            else:
                b.comp_type = sd.symbol(cdf["COMPOUND_TYPE"][b.size])
            if b.comp_type == COMPOUND_WEDGE:
                b.wedge_index = sd.symbol(cdf["WEDGE_INDEX"][b.size])
                b.wedge_sign = sd.literal(1)
            elif b.comp_type == COMPOUND_DIFFWTD:
                b.mask_type = sd.literal(1)
        elif b.interintra:
            b.comp_type = COMPOUND_WEDGE if b.wedge_ii else COMPOUND_INTRA
        # interpolation filters
        if d.interp_filter == SWITCHABLE:
            f = [EIGHTTAP, EIGHTTAP]
            for dr in range(2 if s["dual_filter"] else 1):
                large = min(bw4, bh4) >= 2
                if b.skip_mode or b.motion_mode == LOCALWARP:
                    need = False
                elif large and b.y_mode == GLOBALMV:
                    need = d.gm_type[b.ref[0]] == TRANSLATION
                elif large and b.y_mode == GLOBAL_GLOBALMV:
                    need = d.gm_type[b.ref[0]] == TRANSLATION or \
                        d.gm_type[b.ref[1]] == TRANSLATION
                else:
                    need = True
                if need:
                    ctx = ((dr & 1) * 2 + (b.ref[1] > INTRA_FRAME)) * 4
                    lt = at = 3
                    if self.left_b is not None and b.ref[0] in self.lref:
                        lt = self.left_b.interp[dr]
                    if self.above_b is not None and b.ref[0] in self.aref:
                        at = self.above_b.interp[dr]
                    if lt == at:
                        ctx += lt
                    elif lt == 3:
                        ctx += at
                    elif at == 3:
                        ctx += lt
                    else:
                        ctx += 3
                    f[dr] = sd.symbol(cdf["INTERP_FILTER"][ctx])
            if not s["dual_filter"]:
                f[1] = f[0]
            b.interp = tuple(f)
        else:
            b.interp = (d.interp_filter, d.interp_filter)

    def set_avail(self, b):
        """Sets `has_chroma` and the neighbours' availability (the tile's
        own) of the block at b.row, b.col for its luma and chroma; returns
        has_chroma."""
        d = self.d
        r, c = b.row, b.col
        bw4, bh4 = BW4[b.size], BH4[b.size]
        if bh4 == 1 and d.ssy and not (r & 1):
            has_chroma = False
        elif bw4 == 1 and d.ssx and not (c & 1):
            has_chroma = False
        else:
            has_chroma = d.nplanes > 1
        self.has_chroma = has_chroma
        avail_u = self.inside(r - 1, c)
        avail_l = self.inside(r, c - 1)
        self.avail_u, self.avail_l = avail_u, avail_l
        self.avail_uc, self.avail_lc = avail_u, avail_l
        if has_chroma:
            if d.ssy and bh4 == 1:
                self.avail_uc = self.inside(r - 2, c)
            if d.ssx and bw4 == 1:
                self.avail_lc = self.inside(r, c - 2)
        else:
            self.avail_uc = self.avail_lc = False
        b.avail = (avail_u, avail_l, self.avail_uc, self.avail_lc)
        return has_chroma

    def y_mode_cdf(self, above, left):
        """The key frame's luma mode CDF under the modes above and left."""
        am = above.y_mode if above else DC_PRED
        lm = left.y_mode if left else DC_PRED
        return self.cdf["KF_Y_MODE"][INTRA_MODE_CTX[am]][INTRA_MODE_CTX[lm]]

    def uv_mode_cdf(self, b):
        """The chroma mode CDF of a block under its luma mode."""
        return self.cdf["UV_MODE_CFL_ALLOWED" if self.cfl_allowed(b) else
                        "UV_MODE_CFL_NOT_ALLOWED"][b.y_mode]

    def cfl_allowed(self, b):
        d = self.d
        bw4, bh4 = BW4[b.size], BH4[b.size]
        if d.lossless[b.seg]:
            return _BSIZE.get((max(bw4 >> d.ssx, 1),
                               max(bh4 >> d.ssy, 1))) == B4X4
        return max(bw4, bh4) <= 8

    def intra_segment_id(self, b, r, c, avail_u, avail_l):
        d = self.d
        if not d.seg_enabled:
            b.seg = 0
            return
        mi = d.mi
        prev_ul = mi[r - 1][c - 1].seg if avail_u and avail_l else -1
        prev_u = mi[r - 1][c].seg if avail_u else -1
        prev_l = mi[r][c - 1].seg if avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if b.skip:
            b.seg = pred
            return
        if prev_ul < 0:
            ctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            ctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            ctx = 1
        else:
            ctx = 0
        v = self.sd.symbol(self.cdf["SEGMENT_ID"][ctx])
        mx = d.last_seg + 1
        # neg_deinterleave
        if not pred:
            s = v
        elif pred >= mx - 1:
            s = mx - v - 1
        elif 2 * pred < mx:
            if v <= 2 * pred:
                s = pred + ((v + 1) >> 1) if v & 1 else pred - (v >> 1)
            else:
                s = v
        else:
            if v <= 2 * (mx - pred - 1):
                s = pred + ((v + 1) >> 1) if v & 1 else pred - (v >> 1)
            else:
                s = mx - (v + 1)
        b.seg = max(0, min(d.last_seg, s))

    def read_cdef(self, b, r, c, bsize):
        d = self.d
        if b.skip or d.coded_lossless or not d.seq["cdef"] or \
                d.allow_intrabc:
            return
        r0, c0 = r & ~15, c & ~15
        if d.cdef_idx.get((r0, c0), -1) == -1:
            v = self.sd.literal(d.cdef_bits, None if self.plans is None
                                else 0)
            d.cdef_idx[(r0, c0)] = v
            for y in range(r0, r0 + BH4[bsize], 16):
                for x in range(c0, c0 + BW4[bsize], 16):
                    d.cdef_idx[(y, x)] = v

    def read_delta_q(self):
        d = self.d
        want = None if self.plans is None else \
            (self.plan_q - self.current_q) >> d.delta_q_res
        v = self.read_delta(self.cdf["DELTA_Q"], want)
        if v:
            self.current_q = max(1, min(255, self.current_q +
                                        (v << d.delta_q_res)))

    def read_delta_lf(self):
        d = self.d
        if not d.delta_lf_present:
            return
        n = 1
        if d.delta_lf_multi:
            n = 4 if d.nplanes > 1 else 2
        for i in range(n):
            cdf = self.cdf["DELTA_LF_MULTI"][i] if d.delta_lf_multi else \
                self.cdf["DELTA_LF"]
            v = self.read_delta(cdf, None if self.plans is None else 0)
            if v:
                self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] +
                                                (v << d.delta_lf_res)))

    def read_delta(self, cdf, want):
        """A signed delta (delta_q_abs or delta_lf_abs, its remaining
        bits and sign)."""
        sd = self.sd
        a = None if want is None else abs(want)
        v = sd.symbol(cdf, None if a is None else min(a, 3))
        if v == 3:
            bits = None if a is None else (a - 1).bit_length() - 1
            bits = sd.literal(3, None if a is None else bits - 1) + 1
            v = sd.literal(bits, None if a is None else
                           a - 1 - (1 << bits)) + (1 << bits) + 1
        if v and sd.literal(1, None if a is None else int(want < 0)):
            v = -v
        return v

    def read_cfl(self, b, p=None):
        sd, cdf = self.sd, self.cdf
        want = None
        if p is not None:
            su, sv = ((0 if a == 0 else 1 if a < 0 else 2)
                      for a in (p.cfl_u, p.cfl_v))
            want = su * 3 + sv - 1
        signs = sd.symbol(cdf["CFL_SIGN"], want)
        su, sv = (signs + 1) // 3, (signs + 1) % 3
        if su:
            a = sd.symbol(cdf["CFL_ALPHA"][(su - 1) * 3 + sv],
                          p and abs(p.cfl_u) - 1) + 1
            b.cfl_u = -a if su == 1 else a
        if sv:
            a = sd.symbol(cdf["CFL_ALPHA"][(sv - 1) * 3 + su],
                          p and abs(p.cfl_v) - 1) + 1
            b.cfl_v = -a if sv == 1 else a

    # ---- palettes -----------------------------------------------------------
    def palette_cache(self, b, r, c, plane, above, left):
        above_n = left_n = 0
        if (r * 4) % 64 and above is not None:
            above_n = above.pal_size[plane]
        if left is not None:
            left_n = left.pal_size[plane]
        ac = above.pal_colors[plane] if above_n else ()
        lc = left.pal_colors[plane] if left_n else ()
        ai = li = 0
        cache = []
        while ai < above_n and li < left_n:
            a, l_ = ac[ai], lc[li]
            if l_ < a:
                if not cache or l_ != cache[-1]:
                    cache.append(l_)
                li += 1
            else:
                if not cache or a != cache[-1]:
                    cache.append(a)
                ai += 1
                if l_ == a:
                    li += 1
        for v in list(ac[ai:above_n]) + list(lc[li:left_n]):
            if not cache or v != cache[-1]:
                cache.append(v)
        return cache

    def _palette_colors(self, b, r, c, plane, n, above, left):
        d, sd = self.d, self.sd
        bd = d.bd
        cache = self.palette_cache(b, r, c, plane, above, left)
        colors = []
        for v in cache:
            if len(colors) >= n:
                break
            if sd.literal(1):
                colors.append(v)
        if len(colors) < n:
            colors.append(sd.literal(bd))
        if len(colors) < n:
            bits = bd - 3 + sd.literal(2)
            while len(colors) < n:
                delta = sd.literal(bits)
                if plane == 0:
                    delta += 1
                v = min(colors[-1] + delta, (1 << bd) - 1)
                colors.append(v)
                rng = (1 << bd) - v - (1 if plane == 0 else 0)
                bits = min(bits, max(rng - 1, 0).bit_length()
                           if rng > 0 else 0)
        return sorted(colors)

    def palette_mode_info(self, b, r, c, above, left):
        d, sd, cdf = self.d, self.sd, self.cdf
        bctx = BLOG2W[b.size] + BLOG2H[b.size] - 2
        ny = nuv = 0
        ycol, ucol, vcol = (), (), ()
        if b.y_mode == DC_PRED:
            ctx = (1 if above is not None and above.pal_size[0] else 0) + \
                  (1 if left is not None and left.pal_size[0] else 0)
            if sd.symbol(cdf["PALETTE_Y_MODE"][bctx][ctx]):
                ny = sd.symbol(cdf["PALETTE_Y_SIZE"][bctx]) + 2
                ycol = tuple(self._palette_colors(b, r, c, 0, ny, above,
                                                  left))
        if self.has_chroma and b.uv_mode == DC_PRED:
            if sd.symbol(cdf["PALETTE_UV_MODE"][1 if ny else 0]):
                nuv = sd.symbol(cdf["PALETTE_UV_SIZE"][bctx]) + 2
                ucol = tuple(self._palette_colors(b, r, c, 1, nuv, above,
                                                  left))
                bd = d.bd
                if sd.literal(1):
                    bits = bd - 4 + sd.literal(2)
                    mx = 1 << bd
                    v = [sd.literal(bd)]
                    for _ in range(1, nuv):
                        delta = sd.literal(bits)
                        if delta and sd.literal(1):
                            delta = -delta
                        val = v[-1] + delta
                        if val < 0:
                            val += mx
                        if val >= mx:
                            val -= mx
                        v.append(min(max(val, 0), mx - 1))
                    vcol = tuple(v)
                else:
                    vcol = tuple(sd.literal(bd) for _ in range(nuv))
        b.pal_size = (ny, nuv)
        b.pal_colors = (ycol, ucol)
        b.pal_v = vcol

    def _color_map(self, n, bw, bh, onw, onh, plane_cdf):
        sd = self.sd
        cm = [[0] * bw for _ in range(bh)]
        cm[0][0] = sd.ns(n)
        cdfs = plane_cdf[n - 2]
        for i in range(1, onh + onw - 1):
            for j in range(min(i, onw - 1), max(0, i - onh + 1) - 1, -1):
                r_, c_ = i - j, j
                scores = [0] * 8
                if c_ > 0:
                    scores[cm[r_][c_ - 1]] += 2
                if r_ > 0 and c_ > 0:
                    scores[cm[r_ - 1][c_ - 1]] += 1
                if r_ > 0:
                    scores[cm[r_ - 1][c_]] += 2
                order = list(range(8))
                for k in range(3):
                    mxs, mxi = scores[k], k
                    for m in range(k + 1, n):
                        if scores[m] > mxs:
                            mxs, mxi = scores[m], m
                    if mxi != k:
                        mxs = scores[mxi]
                        mo = order[mxi]
                        for m in range(mxi, k, -1):
                            scores[m] = scores[m - 1]
                            order[m] = order[m - 1]
                        scores[k] = mxs
                        order[k] = mo
                h = scores[0] + 2 * scores[1] + 2 * scores[2]
                idx = sd.symbol(cdfs[PALETTE_COLOR_CONTEXT[h]])
                cm[r_][c_] = order[idx]
        for i in range(onh):
            for j in range(onw, bw):
                cm[i][j] = cm[i][onw - 1]
        for i in range(onh, bh):
            cm[i] = list(cm[onh - 1])
        return cm

    def palette_tokens(self, b, r, c):
        d = self.d
        bw, bh = 4 * BW4[b.size], 4 * BH4[b.size]
        onh = min(bh, (d.mi_rows - r) * 4)
        onw = min(bw, (d.mi_cols - c) * 4)
        if b.pal_size[0]:
            b.color_map_y = self._color_map(b.pal_size[0], bw, bh, onw, onh,
                                            self.cdf["PALETTE_Y_COLOR"])
        if b.pal_size[1]:
            bw >>= d.ssx
            bh >>= d.ssy
            onw >>= d.ssx
            onh >>= d.ssy
            if bw < 4:
                bw += 2
                onw += 2
            if bh < 4:
                bh += 2
                onh += 2
            b.color_map_uv = self._color_map(b.pal_size[1], bw, bh, onw, onh,
                                             self.cdf["PALETTE_UV_COLOR"])

    # ---- transform size -----------------------------------------------------
    def read_tx_size(self, b, r, c, above, left):
        d = self.d
        bsize = b.size
        if b.lossless:
            b.tx_size = TX_4X4
            return
        tx = MAX_TX_RECT[bsize]
        if d.tx_mode_select and b.is_inter and not b.skip and bsize > B4X4:
            from .av1_mv import read_var_tx_size
            b.tx_size = read_var_tx_size(self, b, r, c)
            return
        if bsize > B4X4 and (not b.skip or not b.is_inter) and \
                d.tx_mode_select:
            mw, mh = TXW[tx], TXH[tx]
            if above is None:
                aw = 0
            elif above.is_inter:
                aw = 4 * BW4[above.size]
            else:
                aw = self.above_tx_w(r, c)
            if left is None:
                lh = 0
            elif left.is_inter:
                lh = 4 * BH4[left.size]
            else:
                lh = self.left_tx_h(r, c)
            ctx = (aw >= mw) + (lh >= mh)
            depth = self.sd.symbol(self.cdf["TX_SIZE"][TX_CAT[bsize]][ctx])
            for _ in range(depth):
                tx = SPLIT_TX[tx]
        b.tx_size = tx

    def above_tx_w(self, r, c):
        a = self.d.mi[r - 1][c]
        if a.skip and a.is_inter:
            return 4 * BW4[a.size]
        return TXW[self.d.inter_tx[r - 1][c]]

    def left_tx_h(self, r, c):
        a = self.d.mi[r][c - 1]
        if a.skip and a.is_inter:
            return 4 * BH4[a.size]
        return TXH[self.d.inter_tx[r][c - 1]]

    def reset_block_context(self, b):
        d = self.d
        bw4, bh4 = BW4[b.size], BH4[b.size]
        for p in range(1 + 2 * self.has_chroma):
            sx, sy = (d.ssx, d.ssy) if p else (0, 0)
            al, ad = self.above_level[p], self.above_dc[p]
            for i in range(b.col >> sx, (b.col + bw4) >> sx):
                al[i] = 0
                ad[i] = 0
            ll, ld = self.left_level[p], self.left_dc[p]
            for i in range(b.row >> sy, (b.row + bh4) >> sy):
                ll[i] = 0
                ld[i] = 0

    # ---- residual -----------------------------------------------------------
    def plane_tx_size(self, b, plane):
        if plane == 0:
            return b.tx_size
        d = self.d
        pw = max(BW4[b.size] >> d.ssx, 1)
        ph = max(BH4[b.size] >> d.ssy, 1)
        uv = MAX_TX_RECT[_BSIZE[(pw, ph)]]
        if TXW[uv] == 64 or TXH[uv] == 64:
            if TXW[uv] == 16:
                return _TXSIZE[(16, 32)]
            if TXH[uv] == 16:
                return _TXSIZE[(32, 16)]
            return _TXSIZE[(32, 32)]
        return uv

    def residual(self, b):
        d = self.d
        bw4, bh4 = BW4[b.size], BH4[b.size]
        wchunks = max(1, bw4 >> 4)
        hchunks = max(1, bh4 >> 4)
        self.max_luma = (0, 0)
        var_tx = b.var_tx is not None
        for cy in range(hchunks):
            for cx in range(wchunks):
                for p in range(1 + 2 * self.has_chroma):
                    tx = TX_4X4 if b.lossless else self.plane_tx_size(b, p)
                    step_x, step_y = TXW[tx] >> 2, TXH[tx] >> 2
                    sx, sy = (d.ssx, d.ssy) if p else (0, 0)
                    pw4 = max(bw4 >> sx, 1)
                    ph4 = max(bh4 >> sy, 1)
                    base_x = (b.col >> sx) * 4
                    base_y = (b.row >> sy) * 4
                    if var_tx and p == 0:
                        for (tx_, ox, oy) in b.var_tx:
                            if (ox >> 4) == cx and (oy >> 4) == cy:
                                self.transform_block(b, 0, base_x, base_y,
                                                     tx_, ox, oy)
                        continue
                    y0 = (cy * 16) >> sy
                    x0 = (cx * 16) >> sx
                    for y in range(y0, min(ph4, y0 + (16 >> sy)), step_y):
                        for x in range(x0, min(pw4, x0 + (16 >> sx)),
                                       step_x):
                            self.transform_block(b, p, base_x, base_y, tx,
                                                 x, y)

    def transform_block(self, b, plane, base_x, base_y, tx, x, y):
        d = self.d
        start_x, start_y = base_x + 4 * x, base_y + 4 * y
        sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
        row = (start_y << sy) >> 2
        col = (start_x << sx) >> 2
        step_x, step_y = TXW[tx] >> 2, TXH[tx] >> 2
        if start_x >= (d.mi_cols * 4) >> sx or \
                start_y >= (d.mi_rows * 4) >> sy:
            return
        g = self.decoded[plane]
        gy, gx = ((row - self.sb_r) >> sy) + 1, ((col - self.sb_c) >> sx) + 1
        if not b.is_inter:
            rec = self.intra_rec(b, plane, start_x, start_y, tx, x, y)
            if plane == 0:
                self.max_luma = (start_x + step_x * 4, start_y + step_y * 4)
            else:
                rec[12] = self.max_luma
        else:
            rec = [plane, start_x, start_y, tx, b, 0, 0, 0, 0, x, y, None,
                   None]
        self.before_coeffs(rec)
        if not b.skip:
            rec[11] = self.coeffs(b, plane, start_x, start_y, tx)
        self.after_coeffs(rec)
        d.records.append(rec)
        lf = d.lf_tx[plane]
        lf[row >> sy:(row >> sy) + step_y, col >> sx:(col >> sx) + step_x] \
            = tx
        for i in range(step_y):
            if gy + i < len(g):
                gr = g[gy + i]
                for j in range(step_x):
                    if gx + j < len(gr):
                        gr[gx + j] = 1

    def intra_rec(self, b, plane, start_x, start_y, tx, x, y):
        """The record of an intra transform block at (start_x, start_y) of
        its plane, (x, y) 4 x 4 units into its block: [plane, x, y, tx,
        block, have left, have above, have above right, have below left,
        x, y, coefficients, luma extent]."""
        d = self.d
        sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
        row = (start_y << sy) >> 2
        col = (start_x << sx) >> 2
        step_x, step_y = TXW[tx] >> 2, TXH[tx] >> 2
        g = self.decoded[plane]
        gy, gx = ((row - self.sb_r) >> sy) + 1, ((col - self.sb_c) >> sx) + 1
        if plane == 0:
            avail_l, avail_u = self.avail_l, self.avail_u
        else:
            avail_l, avail_u = self.avail_lc, self.avail_uc
        gxr = gx + step_x
        have_ar = g[gy - 1][gxr] if gxr < len(g[0]) else 0
        gyb = gy + step_y
        have_bl = g[gyb][gx - 1] if gyb < len(g) else 0
        return [plane, start_x, start_y, tx, b, avail_l or x > 0,
                avail_u or y > 0, have_ar, have_bl, x, y, None, None]

    def before_coeffs(self, rec):
        pass

    def after_coeffs(self, rec):
        pass

    # ---- coefficients -------------------------------------------------------
    def tx_set(self, b, tx):
        sqr_up = TX_SQR_UP[tx]
        if sqr_up > 3:
            return SET_DCTONLY
        if b.is_inter:
            if self.d.reduced_tx_set or sqr_up == 3:
                return SET_INTER_3
            if TX_SQR[tx] == 2:
                return SET_INTER_2
            return SET_INTER_1
        if sqr_up == 3:
            return SET_DCTONLY
        if self.d.reduced_tx_set:
            return SET_INTRA_2
        if TX_SQR[tx] == 2:
            return SET_INTRA_2
        return SET_INTRA_1

    def read_tx_type(self, b, tx, want=None):
        d = self.d
        tset = self.tx_set(b, tx)
        q = d.qidx(b.seg, None)
        if tset > 0 and q > 0:
            sd, cdf = self.sd, self.cdf
            sqr = TX_SQR[tx]
            if b.is_inter:
                if tset == SET_INTER_1:
                    return INTER_SET1[sd.symbol(cdf["INTER_TX_SET1"][sqr])]
                if tset == SET_INTER_2:
                    return INTER_SET2[sd.symbol(cdf["INTER_TX_SET2"][sqr])]
                return INTER_SET3[sd.symbol(cdf["INTER_TX_SET3"][sqr])]
            mode = FILTER_INTRA_DIR[b.filter_mode] if b.filter_mode >= 0 \
                else b.y_mode
            if tset == SET_INTRA_1:
                return INTRA_SET1[sd.symbol(
                    cdf["INTRA_TX_SET1"][sqr][mode],
                    None if want is None else INTRA_SET1.index(want))]
            return INTRA_SET2[sd.symbol(
                cdf["INTRA_TX_SET2"][sqr][mode],
                None if want is None else INTRA_SET2.index(want))]
        return DCT_DCT

    def plane_tx_type(self, b, plane, tx, luma_type):
        if b.lossless or TX_SQR_UP[tx] > 3:
            return DCT_DCT
        if plane == 0:
            return luma_type
        t = luma_type if b.is_inter else MODE_TO_TXFM[b.uv_mode]
        tset = self.tx_set(b, tx)
        if t not in _IN_SET.get(tset, ()):
            return DCT_DCT
        return t

    def coeffs(self, b, plane, x, y, tx):
        """Reads one transform block's coefficients; returns (tx type,
        {position: signed level}, dc quantiser, ac quantiser, qm level) or
        None when all are zero. An encoder's `cplan` is (tx type, signed
        levels by position, end of block)."""
        d, sd, cdf = self.d, self.sd, self.cdf
        cp = self.cplan
        A = None if cp is None else [abs(v) for v in cp[1]]
        sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
        x4, y4 = x >> 2, y >> 2
        w4, h4 = TXW[tx] >> 2, TXH[tx] >> 2
        max_x4 = d.mi_cols >> sx
        max_y4 = d.mi_rows >> sy
        tx_ctx = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
        ptype = 1 if plane else 0
        al, ad = self.above_level[plane], self.above_dc[plane]
        ll, ld = self.left_level[plane], self.left_dc[plane]
        xe = min(x4 + w4, max_x4)
        ye = min(y4 + h4, max_y4)
        if plane == 0:
            bw, bh = 4 * BW4[b.size], 4 * BH4[b.size]
            if TXW[tx] == bw and TXH[tx] == bh:
                ctx = 0
            else:
                top = max(al[x4:xe], default=0)
                left = max(ll[y4:ye], default=0)
                top, left = min(top, 255), min(left, 255)
                if top == 0 and left == 0:
                    ctx = 1
                elif top == 0 or left == 0:
                    ctx = 2 + (max(top, left) > 3)
                elif max(top, left) <= 3:
                    ctx = 4
                elif min(top, left) <= 3:
                    ctx = 5
                else:
                    ctx = 6
        else:
            above = any(al[x4:xe]) or any(ad[x4:xe])
            left = any(ll[y4:ye]) or any(ld[y4:ye])
            ctx = 7 + above + left
            pw = max(BW4[b.size] >> d.ssx, 1) * 4
            ph = max(BH4[b.size] >> d.ssy, 1) * 4
            if pw * ph > TXW[tx] * TXH[tx]:
                ctx += 3
        all_zero = sd.symbol(cdf["TXB_SKIP"][tx_ctx][ctx],
                             None if cp is None else int(cp[2] == 0))
        if all_zero:
            if plane == 0:
                self.set_tx_types(b, x4, y4, w4, h4, DCT_DCT)
            for i in range(x4, x4 + w4):
                al[i] = 0
                ad[i] = 0
            for i in range(y4, y4 + h4):
                ll[i] = 0
                ld[i] = 0
            return None
        if plane == 0:
            ltype = self.read_tx_type(b, tx, None if cp is None else cp[0])
            self.set_tx_types(b, x4, y4, w4, h4, ltype)
        else:
            ltype = self.luma_tx_type_at(b, x, y) if b.is_inter else None
        txtype = self.plane_tx_type(b, plane, tx, ltype)
        cls = TX_CLASS[txtype]
        info = _scan_info(tx, txtype)
        scan, stride, ppos, base_off, br_off, nb_base, nb_br = info
        adj = TX_ADJ[tx]
        area = TXW[adj] * TXH[adj]
        eob_multi = min(TXLW[tx], 5) + min(TXLH[tx], 5) - 4
        ectx = 0 if cls == CLASS_2D else 1
        eob_cdf = cdf[("EOB_PT_16", "EOB_PT_32", "EOB_PT_64", "EOB_PT_128",
                       "EOB_PT_256", "EOB_PT_512", "EOB_PT_1024")[eob_multi]]
        if cp is not None:
            want = cp[2]
            want_pt = want if want < 3 else (want - 1).bit_length() + 1
            extra = want - (1 << (want_pt - 2)) - 1 if want_pt > 2 else 0
        eob_pt = sd.symbol(eob_cdf[ptype][ectx], None if cp is None else
                           want_pt - 1) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        shift = eob_pt - 3
        if shift >= 0:
            if sd.symbol(cdf["EOB_EXTRA"][tx_ctx][ptype][eob_pt - 3],
                         None if cp is None else (extra >> shift) & 1):
                eob += 1 << shift
            for i in range(1, max(0, eob_pt - 2)):
                k = max(0, eob_pt - 2) - 1 - i
                if sd.literal(1, None if cp is None else (extra >> k) & 1):
                    eob += 1 << k
        lv = [0] * ((TXH[adj] + 4) * stride)
        l3 = list(lv)                       # the levels capped at 3
        base_cdf = cdf["COEFF_BASE"][tx_ctx][ptype]
        br_cdf = cdf["COEFF_BR"][min(tx_ctx, 3)][ptype]
        eob_base = cdf["COEFF_BASE_EOB"][tx_ctx][ptype]
        symbol = sd.symbol
        a0, a1, a2, a3, a4 = nb_base
        b0, b1, b2 = nb_br
        for c in range(eob - 1, -1, -1):
            pos = scan[c]
            p = ppos[pos]
            a = None if A is None else A[pos]
            if c == eob - 1:
                ectx2 = 0 if c == 0 else 1 if c <= area // 8 else \
                    2 if c <= area // 4 else 3
                level = symbol(eob_base[ectx2], a and min(a, 3) - 1) + 1
            else:
                off = base_off[pos]
                ctx = 0 if off < 0 else _HALF4[
                    l3[p + a0] + l3[p + a1] + l3[p + a2] + l3[p + a3] +
                    l3[p + a4]] + off
                level = symbol(base_cdf[ctx], None if a is None else
                               min(a, 3))
            if level > 2:
                # levels here are at most 15, the cap of their context
                bcdf = br_cdf[_HALF6[lv[p + b0] + lv[p + b1] + lv[p + b2]]
                              + br_off[pos]]
                for _ in range(4):
                    k = symbol(bcdf, None if a is None else
                               min(a - level, 3))
                    level += k
                    if k < 3:
                        break
            lv[p] = level
            l3[p] = level if level < 3 else 3
        out = {}
        cul = 0
        dc_cat = 0
        for c in range(eob):
            pos = scan[c]
            level = lv[ppos[pos]]
            if not level:
                continue
            want = None if cp is None else int(cp[1][pos] < 0)
            if c == 0:
                dsign = 0
                for i in range(x4, xe):
                    s_ = ad[i]
                    dsign += -1 if s_ == 1 else 1 if s_ == 2 else 0
                for i in range(y4, ye):
                    s_ = ld[i]
                    dsign += -1 if s_ == 1 else 1 if s_ == 2 else 0
                dctx = 1 if dsign < 0 else 2 if dsign > 0 else 0
                sign = symbol(cdf["DC_SIGN"][ptype][dctx], want)
            else:
                sign = sd.literal(1, want)
            if level > 14:
                gw = None if A is None else A[pos] - 14
                glen = None if A is None else gw.bit_length()
                length = 0
                while True:
                    length += 1
                    if sd.literal(1, None if A is None else
                                  int(length == glen)):
                        break
                    if length > 32:
                        raise IOError("AV1: bad Golomb code")
                g = 1
                for i in range(length - 1):
                    g = (g << 1) | sd.literal(1, None if A is None else (
                        gw >> (length - 2 - i)) & 1)
                level = g + 14
            if pos == 0:
                dc_cat = 1 if sign else 2
            level &= 0xfffff
            cul += level
            out[pos] = -level if sign else level
        cul = min(63, cul)
        for i in range(x4, x4 + w4):
            al[i] = cul
            ad[i] = dc_cat
        for i in range(y4, y4 + h4):
            ll[i] = cul
            ld[i] = dc_cat
        # dequantisation parameters
        q = d.qidx(b.seg, b.qindex)
        bi = (d.bd - 8) >> 1
        dcq = T.DC_Q[bi][max(0, min(255, q + d.dq[plane][0]))]
        acq = T.AC_Q[bi][max(0, min(255, q + d.dq[plane][1]))]
        qm = d.seg_qm[plane][b.seg] if txtype < IDTX else 15
        return (txtype, out, dcq, acq, qm)

    def set_tx_types(self, b, x4, y4, w4, h4, t):
        for j in range(h4):
            for i in range(w4):
                self.tx_types[(y4 + j, x4 + i)] = t

    def luma_tx_type_at(self, b, x, y):
        d = self.d
        # the luma transform type at the chroma block's top-left 4 x 4
        y4 = max(b.row, (y >> 2) << d.ssy)
        x4 = max(b.col, (x >> 2) << d.ssx)
        return self.tx_types.get((y4, x4), DCT_DCT)


# ---- scans and coefficient contexts -------------------------------------
# Min((mag + 1) >> 1, 4) and Min((mag + 1) >> 1, 6) of the level contexts
_HALF4 = tuple(min((m + 1) >> 1, 4) for m in range(16))
_HALF6 = tuple(min((m + 1) >> 1, 6) for m in range(46))
def _default_scan(w, h):
    out = []
    if w == h:
        for s in range(w + h - 1):
            cells = [(r, s - r) for r in range(max(0, s - w + 1),
                                              min(h, s + 1))]
            if s % 2 == 0:
                cells.reverse()
            out += [r * w + c for r, c in cells]
    elif w < h:
        for s in range(w + h - 1):
            out += [r * w + (s - r) for r in range(max(0, s - w + 1),
                                                  min(h, s + 1))]
    else:
        for s in range(w + h - 1):
            out += [r * w + (s - r) for r in range(min(h, s + 1) - 1,
                                                  max(0, s - w + 1) - 1, -1)]
    return out


_SCAN_CACHE = {}


def _base_ctx_offset(w, h, row, col):
    if row == 0 and col == 0:
        return -1
    if w == h:
        if row + col == 1:
            return 1
        return 6 if row + col <= 3 else 21
    if w > h:
        if col < 2:
            return 16
        return 6 if row + col <= 3 else 21
    if row < 2:
        return 11
    return 6 if row + col <= 3 else 21


def _scan_info(tx, txtype):
    key = (tx, txtype)
    info = _SCAN_CACHE.get(key)
    if info is not None:
        return info
    adj = TX_ADJ[tx]
    w, h = TXW[adj], TXH[adj]
    cls = TX_CLASS[txtype]
    n = w * h
    if tx in (17, 18) or TX_SQR_UP[tx] == 4 or txtype == IDTX:
        scan = _default_scan(w, h)
    elif cls == CLASS_VERT:
        scan = list(range(n))
    elif cls == CLASS_HORIZ:
        scan = [r * w + c for c in range(w) for r in range(h)]
    else:
        scan = _default_scan(w, h)
    stride = w + 4
    ppos = [(pos // w) * stride + pos % w for pos in range(n)]
    if cls == CLASS_2D:
        nb = ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0))
        nbr = ((0, 1), (1, 0), (1, 1))
    elif cls == CLASS_HORIZ:
        nb = ((0, 1), (1, 0), (0, 2), (0, 3), (0, 4))
        nbr = ((0, 1), (1, 0), (0, 2))
    else:
        nb = ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0))
        nbr = ((0, 1), (1, 0), (2, 0))
    nb_base = tuple(dr * stride + dc for dr, dc in nb)
    nb_br = tuple(dr * stride + dc for dr, dc in nbr)
    base_off, br_off = [], []
    for pos in range(n):
        row, col = divmod(pos, w)
        if cls == CLASS_2D:
            base_off.append(_base_ctx_offset(TXW[tx], TXH[tx], row, col))
            br_off.append(0 if pos == 0 else 7 if row < 2 and col < 2
                          else 14)
        else:
            idx = row if cls == CLASS_VERT else col
            base_off.append(26 + 5 * min(idx, 2))
            br_off.append(0 if pos == 0 else 7 if idx == 0 else 14)
    info = (scan, stride, ppos, base_off, br_off, nb_base, nb_br)
    _SCAN_CACHE[key] = info
    return info


def _last_nonzero_index(data, start, end):
    """The index of the last nonzero byte of data[start:end], or -1."""
    for i in range(end - 1, start - 1, -1):
        if data[i]:
            return i
    return -1


def _last_nonzero(data, start, end):
    """libaom's get_last_nonzero_byte: that byte's value, or 0."""
    i = _last_nonzero_index(data, start, end)
    return data[i] if i >= 0 else 0


def _single_mode(mode, ref_list):
    """get_mode (5.11.26): the single-reference mode of each list."""
    if mode < NEAREST_NEARESTMV:
        return mode
    if ref_list == 0:
        if mode in (NEW_NEWMV, NEW_NEARESTMV, NEW_NEARMV):
            return NEWMV
        if mode in (NEAREST_NEARESTMV, NEAREST_NEWMV):
            return NEARESTMV
        if mode in (NEAR_NEARMV, NEAR_NEWMV):
            return NEARMV
        return GLOBALMV
    if mode in (NEW_NEWMV, NEAREST_NEWMV, NEAR_NEWMV):
        return NEWMV
    if mode in (NEAREST_NEARESTMV, NEW_NEARESTMV):
        return NEARESTMV
    if mode in (NEAR_NEARMV, NEW_NEARMV):
        return NEARMV
    return GLOBALMV


_MODE_NAMES = ("NEARESTMV", "NEARMV", "GLOBALMV", "NEWMV",
               "NEAREST_NEARESTMV", "NEAR_NEARMV", "NEAREST_NEWMV",
               "NEW_NEARESTMV", "NEAR_NEWMV", "NEW_NEARMV", "GLOBAL_GLOBALMV",
               "NEW_NEWMV")
_COMPOUND_NAMES = ("wedge", "difference weighted", "average", "inter-intra",
                   "distance")
_FILTER_NAMES = ("regular", "smooth", "sharp", "bilinear")


def count_tools(d, c):
    """Adds to Counter c the inter coding tools of the frame parsed last:
    its type, each block's mode, reference kind, motion mode, compound
    type and interpolation filters, the global motion types and skip
    mode."""
    c["frame: " + ("key", "inter", "intra-only", "switch")[d.frame_type]] += 1
    if d.frame_is_intra:
        return
    for ref in range(1, 8):
        if d.gm_type[ref]:
            c["global motion: " + ("", "translation", "rotzoom",
                                   "affine")[d.gm_type[ref]]] += 1
    if d.use_ref_frame_mvs:
        c["frame: use_ref_frame_mvs"] += 1
    if d.error_res:
        c["frame: error resilient"] += 1
    if not d.seq["order_hint_bits"]:
        c["frame: no order hints"] += 1
    if d.primary_ref != PRIMARY_REF_NONE:
        c["frame: primary_ref_frame"] += 1
    if d.seg_enabled:
        c["frame: segmentation"] += 1
    seen = set()
    for row in d.mi:
        for b in row:
            if id(b) in seen:
                continue
            seen.add(id(b))
            if not b.is_inter:
                c["block: intra"] += 1
                continue
            c["mode: " + _MODE_NAMES[b.y_mode - NEARESTMV]] += 1
            if b.ref[1] > INTRA_FRAME:
                kind = "compound bidirectional" if (
                    b.ref[0] < BWDREF_FRAME) != (b.ref[1] < BWDREF_FRAME) \
                    else "compound unidirectional"
                c["compound: " + _COMPOUND_NAMES[b.comp_type]] += 1
            else:
                kind = "single"
            c["reference: " + kind] += 1
            if b.interintra:
                c["inter-intra: " + ("wedge" if b.wedge_ii else
                                     ("DC", "V", "H", "smooth")[
                                         b.ii_mode])] += 1
            c["motion mode: " + ("simple", "OBMC", "local warp")[
                b.motion_mode]] += 1
            f0, f1 = b.interp
            c["filter: " + (_FILTER_NAMES[f0] if f0 == f1 else
                            "dual " + _FILTER_NAMES[f0] + "/" +
                            _FILTER_NAMES[f1])] += 1
            if b.skip_mode:
                c["block: skip_mode"] += 1


def copy_cdfs(cdfs):
    """A copy of a nested table of CDFs (dicts and lists of lists of
    ints), as copy.deepcopy makes it, faster."""
    if isinstance(cdfs, dict):
        return {k: copy_cdfs(v) for k, v in cdfs.items()}
    if cdfs and isinstance(cdfs[0], int):
        return cdfs[:]
    return [copy_cdfs(v) for v in cdfs]


def _clear_counts(cdfs):
    """Sets the symbol counter of every CDF in a nested table to 0."""
    if isinstance(cdfs, dict):
        for v in cdfs.values():
            _clear_counts(v)
    elif cdfs and isinstance(cdfs[0], int):
        cdfs[-1] = 0
    else:
        for v in cdfs:
            _clear_counts(v)


def decode_av1(data: bytes, name: str = "") -> Frame:
    """Decode an AV1 still image (a temporal unit of OBUs) to the planes
    of the last frame it shows, its film grain applied."""
    dec = Decoder(data, name)
    if dec.frame_done:
        dec.finish_frame()
    if dec.output is None:
        raise IOError(f"AV1: no frame shown ({name})")
    frame, grain = dec.output
    if grain is None:
        return frame
    from .av1_grain import apply_grain
    out = copy.copy(frame)
    out.planes = apply_grain(grain, frame.planes, frame.bit_depth,
                             frame.ss_x, frame.ss_y, frame.matrix)
    return out
