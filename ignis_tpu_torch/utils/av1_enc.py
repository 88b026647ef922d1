"""An AV1 intra encoder: one 8-bit 4:2:0 still picture coded as the AVIF
writer of cv2.imwrite (libavif 1.4.2 over libaom) codes it by default, and
read back by av1.py exactly as this encoder reconstructed it.

The stream: a temporal delimiter, a reduced still-picture sequence header
(BT.601 full range, filter intra and the intra edge filter on, CDEF on,
no loop restoration, no film grain) and one frame OBU: a key frame with
base_q_idx 148, the chroma DC and AC delta q of -16, quantiser matrices
at level 8, delta q per 64 x 64 superblock (delta_q_res 2; none where
every superblock keeps base_q_idx, as libaom leaves it), the largest
transform of each block (so the partition chooses the transform size),
uniform tiles in libaom's least layout (`tile_layout`: one tile up to
4,032 pixels a row and 2,304 superblocks), each coded with its own
symbol coder from the default CDFs and contexts, as the decoder resets
them a tile, their sizes in as few bytes as the largest needs and the
largest tile named for the context update, as libaom writes them; then
its deblocking levels (sharpness 1) and its one CDEF strength, chosen
after the tiles by the squared error of the filtered frame against the
source.

Each tile is written by av1.TileDecoder's own parse: TileEncoder answers
each of its reads with the encoder's decision (SymbolEncoder writes it,
SymbolCounter only adds up its cost), so the syntax, its contexts and its
CDF adaptation exist once. Each superblock is searched first: partitions
(square, and the halves the frame's edges force) by their cost, each
block's luma mode among the intra modes a SATD pre-selection keeps, its
chroma mode (CFL with least-squares alphas among them), skip, and each
luma transform's type, with cost = squared error (chroma weighted) +
lambda x bits counted against the CDFs as they stood at the superblock's
start. The search then rolls the superblock back and codes it for real.
Prediction (av1_recon.Recon), dequantisation and the inverse transform
(av1_recon.residuals) are the decoder's own, in decode order, so the
encoder's reconstruction is the decoder's by construction.

Each superblock's q is cv2's kind of choice, by the port's own rule: the
geometric mean of the variance of the source's 8 x 8 luma blocks sets the
ratio of its DC quantiser to base_q_idx's (lower q for flat content),
fitted to libaom's choices on noise and wave images, between 88 and 148.
"""
from __future__ import annotations

import math

import numpy as np

from . import av1_tables as T
from .av1 import (_BSIZE, _IN_SET, B8X8, BH4, BW4, D45, D67, D113, D135,
                  D157, D203, DC_PRED, DCT_DCT, H_PRED, MAX_TX_RECT, PAETH,
                  SMOOTH, SMOOTH_H, SMOOTH_V, TXH, TXW, UV_CFL, V_PRED, Block,
                  BitReader, BitWriter, Decoder, SymbolCounter, SymbolEncoder,
                  TileDecoder, _scan_info, leb128_bytes)
from .av1_fwd import (coefficient_scale, dequantize, forward_transform,
                      inverse_estimate, quantize, quantizers)
from .av1_recon import Recon, residuals

BASE_Q = 148
UV_DELTA_Q = -16
QM_LEVEL = 8
DELTA_Q_RES = 2
MIN_Q = 88
LF_SHARPNESS = 1
CDEF_DAMPING = 5
# (seq_level_idx, MaxPicSize, MaxHSize, MaxVSize) of AV1's levels 2.0-6.0
LEVELS = ((0, 147456, 2048, 1152), (1, 278784, 2816, 1584),
          (4, 665856, 4352, 2448), (5, 1065024, 5504, 3096),
          (8, 2359296, 6144, 3456), (12, 8912896, 8192, 4352),
          (16, 35651584, 16384, 8704))
PART_NONE, PART_HORZ, PART_VERT, PART_SPLIT = 0, 1, 2, 3
# the modes a pre-selection scores: the non-directional ones for every
# block, the six directional ones (at angle delta 0) from 16 x 16 up
FLAT_MODES = (DC_PRED, V_PRED, H_PRED, SMOOTH, SMOOTH_V, SMOOTH_H, PAETH)
ANGLED_MODES = (D45, D135, D113, D157, D203, D67)
CHROMA_WEIGHT = 3.0
LAMBDA = 0.10
ROUNDING = 0.5
KEEP_LARGE, KEEP_SMALL = 2, 2
ANGLED_FROM = 4                   # in 4 x 4 units: from 16 x 16 up


def seq_level(w: int, h: int) -> int:
    """The smallest level whose picture limits take a w x h picture."""
    for idx, area, mw, mh in LEVELS:
        if w * h <= area and w <= mw and h <= mh:
            return idx
    return 31


class Options:
    """What a stream switches on beyond cv2's default still picture (the
    defaults): bit depth `bd` (8 or 10), chroma subsampling `ssx`, `ssy`
    (4:2:0 or 4:4:4, profile 1), the superres denominator `superres`
    (9-16; 8 codes the full width), loop restoration `lr` ({"types": the
    three planes' frame restoration types, RESTORE_*; "shift":
    lr_unit_shift; "uv_shift"; "seed": the seed of the units' random
    parameters}), film grain `grain` (av1_grain's parameter dict, or
    None), `tile_cols` (tile_cols_log2 in place of libaom's layout) and
    `hidden` (a full sequence header, the key frame hidden but showable
    in slot 0, then a frame header that shows it with
    show_existing_frame)."""

    def __init__(self, bd=8, ssx=1, ssy=1, superres=8, lr=None, grain=None,
                 tile_cols=None, hidden=False):
        self.bd, self.ssx, self.ssy = bd, ssx, ssy
        self.superres, self.lr, self.grain = superres, lr, grain
        self.tile_cols, self.hidden = tile_cols, hidden
        self.reduced = not hidden


DEFAULT = Options()


def sequence_header(w: int, h: int, o: Options = DEFAULT) -> bytes:
    """The sequence header OBU's payload of a w x h (upscaled) picture:
    the reduced still-picture header, or with `o.hidden` the full one
    (one operating point, no timing, order hints or frame ids; the
    screen content tools chosen a frame)."""
    bw = BitWriter()
    profile = 1 if (o.ssx, o.ssy) == (0, 0) else 0
    bw.f(3, profile)                # seq_profile
    bw.f(1, int(o.reduced))         # still_picture
    bw.f(1, int(o.reduced))         # reduced_still_picture_header
    if o.reduced:
        bw.f(5, seq_level(w, h))
    else:
        bw.f(1, 0)                  # timing_info_present_flag
        bw.f(1, 0)                  # initial_display_delay_present_flag
        bw.f(5, 0)                  # operating_points_cnt_minus_1
        bw.f(12, 0)                 # operating_point_idc
        bw.f(5, seq_level(w, h))
    wb = max((w - 1).bit_length(), 1)
    hb = max((h - 1).bit_length(), 1)
    bw.f(4, wb - 1)
    bw.f(4, hb - 1)
    bw.f(wb, w - 1)
    bw.f(hb, h - 1)
    if not o.reduced:
        bw.f(1, 0)                  # frame_id_numbers_present_flag
    bw.f(1, 0)                      # use_128x128_superblock
    bw.f(1, 1)                      # enable_filter_intra
    bw.f(1, 1)                      # enable_intra_edge_filter
    if not o.reduced:
        bw.f(4, 0)                  # interintra, masked, warped, dual
        bw.f(1, 0)                  # enable_order_hint
        bw.f(1, 1)                  # seq_choose_screen_content_tools
        bw.f(1, 1)                  # seq_choose_integer_mv
    bw.f(1, int(o.superres != 8))   # enable_superres
    bw.f(1, 1)                      # enable_cdef
    bw.f(1, int(o.lr is not None))  # enable_restoration
    bw.f(1, int(o.bd > 8))          # high_bitdepth
    if profile == 0:
        bw.f(1, 0)                  # mono_chrome
    bw.f(1, 1)                      # color_description_present_flag
    bw.f(8, 1)                      # BT.709 primaries
    bw.f(8, 13)                     # sRGB transfer
    bw.f(8, 6)                      # BT.601 matrix
    bw.f(1, 1)                      # full range
    if profile == 0:
        bw.f(2, 0)                  # chroma_sample_position
    bw.f(1, 0)                      # separate_uv_delta_q
    bw.f(1, int(o.grain is not None))   # film_grain_params_present
    bw.trailing_bits()
    return bw.bytes()


def coded_width(w: int, denom: int) -> int:
    """FrameWidth of an UpscaledWidth w at SuperresDenom `denom`, at
    least Min(16, w) as libaom keeps it."""
    return max((w * 8 + denom // 2) // denom, min(16, w))


def write_grain_params(bw, g, mono, ssx, ssy):
    """film_grain_params() after apply_grain of a key frame: the inverse
    of av1_grain.read_grain_params."""
    bw.f(16, g["seed"])
    bw.f(4, len(g["y"]))
    for pt in g["y"]:
        bw.f(8, pt[0])
        bw.f(8, pt[1])
    if not mono:
        bw.f(1, g["cfl"])
    if not (mono or g["cfl"] or (ssx == 1 and ssy == 1 and not g["y"])):
        for key in ("cb", "cr"):
            bw.f(4, len(g[key]))
            for pt in g[key]:
                bw.f(8, pt[0])
                bw.f(8, pt[1])
    bw.f(2, g["scaling_shift"] - 8)
    bw.f(2, g["lag"])
    for key in ("ar_y", "ar_cb", "ar_cr"):
        for v in g[key]:
            bw.f(8, v + 128)
    bw.f(2, g["ar_shift"] - 6)
    bw.f(2, g["grain_scale_shift"])
    for key in ("cb", "cr"):
        if g[key]:
            bw.f(8, g[key + "_mult"])
            bw.f(8, g[key + "_luma_mult"])
            bw.f(9, g[key + "_offset"])
    bw.f(1, g["overlap"])
    bw.f(1, g["clip"])


def show_existing_header(slot: int = 0) -> bytes:
    """The frame header OBU's payload that shows the frame in `slot`."""
    bw = BitWriter()
    bw.f(1, 1)                      # show_existing_frame
    bw.f(3, slot)                   # frame_to_show_map_idx
    bw.trailing_bits()
    return bw.bytes()


def _tile_log2(blk, target):
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _superblocks(w: int, h: int):
    """The 64 x 64 superblock columns and rows of a w x h frame."""
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    return (mi_cols + 15) >> 4, (mi_rows + 15) >> 4


def tile_layout(w: int, h: int):
    """(tile_cols_log2, tile_rows_log2) of uniform tiles as libaom lays
    them out for cv2: AV1's least (tiles of at most 4,096 pixels a row and
    4,096 x 2,304 pixels), but with libaom's count of the columns, which
    takes one more where the superblock columns are exactly 64 x 2^k
    (two tiles at 4,096 pixels a row); the rows take what the area limit
    still needs."""
    sb_cols, sb_rows = _superblocks(w, h)
    cols = 0
    while (64 << cols) <= sb_cols:
        cols += 1
    cols = min(cols, _tile_log2(1, min(sb_cols, 64)))
    least = max(_tile_log2(64, sb_cols), _tile_log2(2304, sb_rows * sb_cols))
    return cols, max(least - cols, 0)


def frame_header(w: int, h: int, lf, cdef_y, cdef_uv,
                 delta_q: int = 1, context_tile: int = 0,
                 tile_bytes: int = 4, o: Options = DEFAULT) -> bytes:
    """The key frame header's bits, byte aligned, of a frame coded w
    (FrameWidth) x h: the tiles of `tile_layout` (with more than one,
    `context_tile` for the context update and `tile_bytes` a tile size),
    cv2's quantiser fields, delta q (when `delta_q`), the deblocking
    levels `lf` (4), one CDEF strength per plane kind ((primary,
    secondary) of 0-15, 0-4); and what `o` switches on: superres, loop
    restoration, film grain, a hidden frame."""
    bw = BitWriter()
    if not o.reduced:
        bw.f(1, 0)                  # show_existing_frame
        bw.f(2, 0)                  # KEY_FRAME
        bw.f(1, int(not o.hidden))  # show_frame
        if o.hidden:
            bw.f(1, 1)              # showable_frame
            bw.f(1, 0)              # error_resilient_mode
    bw.f(1, 0)                      # disable_cdf_update
    bw.f(1, 0)                      # allow_screen_content_tools
    if not o.reduced:
        bw.f(1, 0)                  # frame_size_override_flag
        if o.hidden:
            bw.f(8, 1)              # refresh_frame_flags: slot 0
    if o.superres != 8:
        bw.f(1, 1)                  # use_superres
        bw.f(3, o.superres - 9)     # coded_denom
    bw.f(1, 0)                      # render_and_frame_size_different
    if not o.reduced:
        bw.f(1, 1)                  # disable_frame_end_update_cdf
    sb_cols, sb_rows = _superblocks(w, h)
    cols, rows = tile_layout(w, h)
    if o.tile_cols is not None:
        cols = o.tile_cols
    bw.f(1, 1)                      # uniform_tile_spacing_flag
    k = _tile_log2(64, sb_cols)     # increment_tile_cols_log2 up to cols
    while k < _tile_log2(1, min(sb_cols, 64)):
        bw.f(1, int(k < cols))
        if k == cols:
            break
        k += 1
    if rows < _tile_log2(1, min(sb_rows, 64)):
        bw.f(1, 0)                  # increment_tile_rows_log2: the least
    if cols or rows:
        bw.f(cols + rows, context_tile)
        bw.f(2, tile_bytes - 1)     # tile_size_bytes_minus_1
    bw.f(8, BASE_Q)
    bw.f(1, 0)                      # DeltaQYDc
    for _ in range(2):              # DeltaQUDc, DeltaQUAc
        bw.f(1, 1)
        bw.su(7, UV_DELTA_Q)
    bw.f(1, 1)                      # using_qmatrix
    bw.f(4, QM_LEVEL)
    bw.f(4, QM_LEVEL)
    bw.f(1, 0)                      # segmentation_enabled
    bw.f(1, delta_q)                # delta_q_present
    if delta_q:
        bw.f(2, DELTA_Q_RES)
        bw.f(1, 0)                  # delta_lf_present
    bw.f(6, lf[0])
    bw.f(6, lf[1])
    if lf[0] or lf[1]:
        bw.f(6, lf[2])
        bw.f(6, lf[3])
    bw.f(3, LF_SHARPNESS)
    bw.f(1, 1)                      # loop_filter_delta_enabled
    bw.f(1, 0)                      # loop_filter_delta_update
    bw.f(2, CDEF_DAMPING - 3)
    bw.f(2, 0)                      # cdef_bits
    for pri, sec in (cdef_y, cdef_uv):
        bw.f(4, pri)
        bw.f(2, 3 if sec == 4 else sec)
    if o.lr is not None:
        types = o.lr["types"]
        for t in types:             # the inverse of REMAP_LR
            bw.f(2, (0, 2, 3, 1)[t])
        if any(types):
            bw.f(1, int(o.lr["shift"] > 0))
            if o.lr["shift"]:
                bw.f(1, o.lr["shift"] - 1)
            if o.ssx and o.ssy and any(types[1:]):
                bw.f(1, o.lr["uv_shift"])
    bw.f(1, 0)                      # tx_mode_select: the largest
    bw.f(1, 0)                      # reduced_tx_set
    if o.grain is not None:
        bw.f(1, 1)                  # apply_grain
        write_grain_params(bw, o.grain, 0, o.ssx, o.ssy)
    bw.byte_align()
    return bw.bytes()


def _obu(kind: int, payload: bytes) -> bytes:
    return bytes([(kind << 3) | 2]) + leb128_bytes(len(payload)) + payload


def frame_state(seq: bytes, hdr: bytes) -> Decoder:
    """The decoder's frame state for these headers, as av1.Decoder reads
    them: what the tile syntax and the filters run against."""
    d = Decoder.__new__(Decoder)
    d.name, d.seq, d.frame_done = "", None, False
    d.slots, d.saved, d.output = [None] * 8, [None] * 8, None
    d.sequence_header(BitReader(seq))
    d.frame_header(BitReader(hdr))
    d.begin_frame()
    return d


# ---- superblock q ---------------------------------------------------------
def sb_qindex(luma: np.ndarray, w: int, h: int, r4: int, c4: int) -> int:
    """The q of the superblock at 4 x 4 unit (r4, c4): from the geometric
    mean variance of its 8 x 8 luma blocks inside the picture."""
    y0, x0 = r4 * 4, c4 * 4
    blk = luma[y0:min(y0 + 64, h), x0:min(x0 + 64, w)].astype(np.float64)
    bh, bw = blk.shape[0] // 8, blk.shape[1] // 8
    if bh == 0 or bw == 0:
        var = blk.var()
    else:
        t = blk[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        v = t.reshape(bh, bw, 64).var(-1)
        var = math.exp(np.log(v + 1.0).mean()) - 1.0
    ratio = math.sqrt(min(1.0, 0.1686 + 0.02683 * math.sqrt(max(var, 0.0))))
    target = T.DC_Q[0][BASE_Q] * ratio
    best = BASE_Q
    for q in range(BASE_Q, MIN_Q - 1, -(1 << DELTA_Q_RES)):
        if abs(T.DC_Q[0][q] - target) < abs(T.DC_Q[0][best] - target):
            best = q
    return best


# ---- the tile ---------------------------------------------------------------
class Plan:
    """The mode info the encoder gives a block: what TileDecoder.block
    reads (angle deltas 0, no filter intra, the largest transform), and
    the luma transform types it chose, by position."""
    __slots__ = ("skip", "y_mode", "angle_y", "uv_mode", "angle_uv", "cfl_u",
                 "cfl_v", "filter_mode", "txt")

    def __init__(self, y_mode, uv_mode):
        self.skip, self.y_mode, self.uv_mode = 0, y_mode, uv_mode
        self.angle_y = self.angle_uv = self.cfl_u = self.cfl_v = 0
        self.filter_mode = -1
        self.txt = {}

    def copy(self, **kw):
        p = Plan.__new__(Plan)
        for k in Plan.__slots__:
            setattr(p, k, getattr(self, k))
        p.txt = {}
        for k, v in kw.items():
            setattr(p, k, v)
        return p


class _NoRecords:
    """The encoder keeps no records: it reconstructs as it goes."""

    def append(self, rec):
        pass


_HADAMARD = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1],
                      [1, -1, -1, 1]], np.int64)


def _satd(diff: np.ndarray) -> float:
    """Sum of absolute 4 x 4 Hadamard coefficients of a residual (whose
    sides are multiples of 4, as every transform's are)."""
    h, w = diff.shape
    t = diff.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3)
    return float(np.abs(_HADAMARD @ t @ _HADAMARD.T).sum()) / 4.0


def padded_source(rc, planes):
    """The source planes (int32, cropped) in buffers of the
    reconstruction's size, edges replicated, and their visible sizes."""
    src, vis = [], []
    for p, plane in enumerate(planes):
        buf = np.zeros_like(rc.planes[p])
        ph, pw = plane.shape
        buf[:ph, :pw] = plane
        buf[:ph, pw:] = plane[:, -1:]
        buf[ph:, :] = buf[ph - 1:ph, :]
        src.append(buf)
        vis.append((ph, pw))
    return src, vis


class TileEncoder(TileDecoder):
    """Codes the tile of frame state `d` over 4 x 4 rows r0-r1 and
    columns c0-c1 into the frame's reconstruction `rc`, from the padded
    source planes `src` (`padded_source`: planes, visible sizes) and
    superblock q's `sb_q` {(r4, c4): q}, with a symbol coder and the
    contexts of its own."""

    def __init__(self, d, rc, source, sb_q, r0, r1, c0, c1):
        super().__init__(d, SymbolCounter(), r0, r1, c0, c1)
        d.records = _NoRecords()
        self.counter = self.sd
        self.writer = SymbolEncoder(d.disable_cdf_update)
        self.rc = rc
        self.parts, self.plans = {}, {}
        self.sb_q = sb_q
        self.src, self.vis = source
        self.dist = 0.0
        self.nonzero = 0
        self.searching = False
        self.pred_cache = {}
        self.qs = {}

    # ---- frame --------------------------------------------------------------
    def encode(self) -> bytes:
        self.decode()               # the tile's superblocks in order
        return self.writer.done()

    def superblock(self, r, c, bsize):
        """Searches the superblock against the counter, rolls it back,
        then codes it for real through the decoder's own superblock."""
        d = self.d
        self.plan_q = self.sb_q[(r, c)]
        q8 = T.AC_Q[(d.bd - 8) >> 1][self.plan_q] / 8.0
        self.lam = LAMBDA * q8 * q8
        self.read_deltas = d.delta_q_present
        d.cdef_idx[(r, c)] = -1
        self.clear_decoded(r, c)
        start = self.snapshot(r, c, bsize)
        self.sd, self.searching = self.counter, True
        self.search(r, c, bsize)
        self.restore(start)
        self.sd, self.searching = self.writer, False
        super().superblock(r, c, bsize)

    # ---- state of a region, for the search ----------------------------------
    def snapshot(self, r, c, bsize):
        d = self.d
        r1 = min(r + BH4[bsize], d.mi_rows)
        c1 = min(c + BW4[bsize], d.mi_cols)
        pix, lf = [], []
        for p in range(d.nplanes):
            sx, sy = (d.ssx, d.ssy) if p else (0, 0)
            pix.append(self.rc.planes[p][(r * 4) >> sy:(r1 * 4) >> sy,
                                         (c * 4) >> sx:(c1 * 4) >> sx].copy())
            lf.append(d.lf_tx[p][r >> sy:(r1 + sy) >> sy,
                                 c >> sx:(c1 + sx) >> sx].copy())
        mi = [d.mi[y][c:c1] for y in range(r, r1)]
        itx = [d.inter_tx[y][c:c1] for y in range(r, r1)]
        ctx = [list(a) for a in (self.above_level + self.above_dc +
                                 self.left_level + self.left_dc)]
        dec = [[list(row) for row in g] for g in self.decoded]
        sb = (r & ~15, c & ~15)
        return (r, c, r1, c1, pix, lf, mi, itx, ctx, dec, self.current_q,
                self.read_deltas, list(self.delta_lf), d.cdef_idx.get(sb, -1))

    def restore(self, snap):
        d = self.d
        (r, c, r1, c1, pix, lf, mi, itx, ctx, dec, q, rd, dlf, cidx) = snap
        for p in range(d.nplanes):
            sx, sy = (d.ssx, d.ssy) if p else (0, 0)
            self.rc.planes[p][(r * 4) >> sy:(r1 * 4) >> sy,
                              (c * 4) >> sx:(c1 * 4) >> sx] = pix[p]
            d.lf_tx[p][r >> sy:(r1 + sy) >> sy, c >> sx:(c1 + sx) >> sx] = \
                lf[p]
        for i, y in enumerate(range(r, r1)):
            d.mi[y][c:c1] = mi[i]
            d.inter_tx[y][c:c1] = itx[i]
        for cur, saved in zip(self.above_level + self.above_dc +
                              self.left_level + self.left_dc, ctx):
            cur[:] = saved
        for g, saved in zip(self.decoded, dec):
            for row, srow in zip(g, saved):
                row[:] = srow
        self.current_q, self.read_deltas = q, rd
        self.delta_lf[:] = dlf
        d.cdef_idx[(r & ~15, c & ~15)] = cidx

    # ---- search -------------------------------------------------------------
    def search(self, r, c, bsize, bound=math.inf):
        """Chooses the partition of the node at (r, c) and everything
        under it; leaves the region coded as chosen; returns its cost, or
        inf once no choice can cost less than `bound`."""
        d = self.d
        if r >= d.mi_rows or c >= d.mi_cols:
            return 0.0
        half = BW4[bsize] >> 1
        has_rows = (r + half) < d.mi_rows
        has_cols = (c + half) < d.mi_cols
        opts = []
        if has_rows and has_cols:
            opts.append(PART_NONE)
        elif has_cols:
            opts.append(PART_HORZ)
        elif has_rows:
            opts.append(PART_VERT)
        if bsize > B8X8:
            opts.append(PART_SPLIT)
        pre = self.snapshot(r, c, bsize)
        best = None
        for opt in opts:
            if best is not None:
                self.restore(pre)
            limit = bound if best is None else min(bound, best[0])
            cost = self.try_partition(r, c, bsize, opt, limit)
            if best is None or cost < best[0]:
                best = (cost, opt, self.snapshot(r, c, bsize)
                        if opt != opts[-1] else None)
            if opt == PART_NONE and self.early_stop:
                break
        if best[0] == math.inf:
            return math.inf
        if best[2] is not None:
            self.restore(best[2])
        self.parts[(r, c, bsize)] = best[1]
        return best[0]

    def try_partition(self, r, c, bsize, opt, bound):
        n4 = BW4[bsize]
        half = n4 >> 1
        self.parts[(r, c, bsize)] = opt
        bits = self.counter.bits
        self.read_partition(r, c, bsize)
        cost = self.lam * (self.counter.bits - bits)
        self.early_stop = False
        if opt == PART_SPLIT:
            sub = _BSIZE[(half, half)]
            for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
                if cost >= bound:
                    return math.inf
                cost += self.search(r + dr, c + dc, sub, bound - cost)
            return cost
        if opt == PART_NONE:
            sub = bsize
        elif opt == PART_HORZ:
            sub = _BSIZE[(n4, half)]
        else:
            sub = _BSIZE[(half, n4)]
        return cost + self.search_block(r, c, sub)

    def search_block(self, r, c, bsize):
        """Chooses the modes of the block at (r, c): its luma mode among
        the pre-selected ones, then CFL or the pre-selected chroma mode;
        leaves it coded so; returns its cost."""
        pre = self.snapshot(r, c, bsize)
        ys, uv = self.preselect(r, c, bsize)
        best = None

        def attempt(plan):
            nonlocal best
            self.restore(pre)
            cost = self.try_block(r, c, bsize, plan, pre)
            if best is None or cost < best[0]:
                best = (cost, self.plans[(r, c, bsize)],
                        self.snapshot(r, c, bsize), self.block_nonzero)

        for y_mode in ys:
            attempt(Plan(y_mode, uv))
        if self.has_chroma and self.cfl_allowed_size(bsize) and \
                not best[1].skip and self.d.ssx and self.d.ssy:
            cfl = self.cfl_alphas(r, c, bsize, best[2])
            if cfl != (0, 0):
                attempt(best[1].copy(uv_mode=UV_CFL, cfl_u=cfl[0],
                                     cfl_v=cfl[1]))
        self.restore(best[2])
        self.plans[(r, c, bsize)] = best[1]
        self.pred_cache = {}
        # a block that codes nothing at its best ends the split search
        self.early_stop = best[3] == 0 and BW4[bsize] <= 8
        return best[0]

    def try_block(self, r, c, bsize, plan, pre):
        bits = self.counter.bits
        self.dist, self.nonzero = 0.0, 0
        self.plans[(r, c, bsize)] = plan
        self.block(r, c, bsize)
        if not plan.skip and self.nonzero == 0:
            # nothing coded: the skip flag says it for less
            self.restore(pre)
            plan = plan.copy(skip=1)
            self.plans[(r, c, bsize)] = plan
            bits = self.counter.bits
            self.dist = 0.0
            self.block(r, c, bsize)
        self.block_nonzero = self.nonzero
        return self.dist + self.lam * (self.counter.bits - bits)

    def cfl_allowed_size(self, bsize):
        return max(BW4[bsize], BH4[bsize]) <= 8

    # ---- mode pre-selection -------------------------------------------------
    def preselect(self, r, c, bsize):
        """The luma modes worth coding (by SATD and mode cost, at angle
        delta 0) and the best chroma mode other than CFL."""
        d = self.d
        b = Block()
        b.row, b.col, b.size = r, c, bsize
        b.is_inter, b.filter_mode = 0, -1
        b.angle_y = b.angle_uv = 0
        b.cfl_u = b.cfl_v = 0
        b.y_mode = b.uv_mode = DC_PRED
        has_chroma = self.set_avail(b)
        tx = MAX_TX_RECT[bsize]
        rec = self.intra_rec(b, 0, c * 4, r * 4, tx, 0, 0)
        w, h = TXW[tx], TXH[tx]
        buf, src = self.rc.planes[0], self.src[0]
        cdf = self.y_mode_cdf(d.mi[r - 1][c] if b.avail[0] else None,
                              d.mi[r][c - 1] if b.avail[1] else None)
        cost = self.counter.cost
        lam_sad = math.sqrt(self.lam)
        scored = []
        y0, x0 = r * 4, c * 4
        cache = self.pred_cache = {}
        modes = FLAT_MODES + (ANGLED_MODES if BW4[bsize] >= ANGLED_FROM
                               else ())
        for m in modes:
            b.y_mode = m
            self.rc.predict_intra(rec)
            pred = buf[y0:y0 + h, x0:x0 + w]
            cache[(0, m, tx)] = pred.copy()
            diff = src[y0:y0 + h, x0:x0 + w] - pred
            bits = cost[cdf[m] - (cdf[m - 1] if m else 0)]
            scored.append((_satd(diff) + lam_sad * bits, m))
        scored.sort()
        keep = KEEP_LARGE if BW4[bsize] >= 4 else KEEP_SMALL
        ys = [m for _, m in scored[:keep]]
        uv = DC_PRED
        if has_chroma:
            b.y_mode, b.seg = ys[0], 0
            ctx = self.uv_mode_cdf(b)
            sx, sy = d.ssx, d.ssy
            utx = self.plane_tx_size(b, 1)
            cw, ch = TXW[utx], TXH[utx]
            recs = [self.intra_rec(b, p, (c * 4) >> sx, (r * 4) >> sy, utx,
                                   0, 0) for p in (1, 2)]
            cy0, cx0 = (r * 4) >> sy, (c * 4) >> sx
            best = None
            for m in modes:
                b.uv_mode = m
                s = 0.0
                for p, rec_ in zip((1, 2), recs):
                    self.rc.predict_intra(rec_)
                    pred = self.rc.planes[p][cy0:cy0 + ch, cx0:cx0 + cw]
                    cache[(p, m, utx)] = pred.copy()
                    s += _satd(self.src[p][cy0:cy0 + ch, cx0:cx0 + cw] -
                               pred)
                s = s * CHROMA_WEIGHT ** 0.5 + lam_sad * cost[
                    ctx[m] - (ctx[m - 1] if m else 0)]
                if best is None or s < best[0]:
                    best = (s, m)
            uv = best[1]
        return ys, uv

    def cfl_alphas(self, r, c, bsize, post):
        """CFL's alphas (u, v) for the block whose luma is coded as in the
        state `post`: least squares of the source chroma less its DC
        prediction on the reconstructed luma's AC, in eighths, within
        -16 .. 16."""
        d = self.d
        cur = self.snapshot(r, c, bsize)
        self.restore(post)
        b = Block()
        b.row, b.col, b.size = r, c, bsize
        b.is_inter, b.filter_mode = 0, -1
        b.angle_y = b.angle_uv = 0
        b.y_mode, b.uv_mode = DC_PRED, DC_PRED
        self.set_avail(b)
        sx, sy = d.ssx, d.ssy
        tx = self.plane_tx_size(b, 1)
        w, h = TXW[tx], TXH[tx]
        y0, x0 = (r * 4) >> sy, (c * 4) >> sx
        luma = self.rc.planes[0].astype(np.int64)
        ly, lx = r * 4, c * 4
        t = (luma[ly:ly + 2 * h:2, lx:lx + 2 * w:2] +
             luma[ly + 1:ly + 2 * h:2, lx:lx + 2 * w:2] +
             luma[ly:ly + 2 * h:2, lx + 1:lx + 2 * w:2] +
             luma[ly + 1:ly + 2 * h:2, lx + 1:lx + 2 * w:2]) << 1
        ac = (t - t.mean()).astype(np.float64)
        den = float((ac * ac).sum())
        out = []
        for p in (1, 2):
            rec = self.intra_rec(b, p, x0, y0, tx, 0, 0)
            self.rc.predict_intra(rec)
            dc = self.rc.planes[p][y0:y0 + h, x0:x0 + w].astype(np.float64)
            s = self.src[p][y0:y0 + h, x0:x0 + w].astype(np.float64)
            a = 0 if den == 0 else 64.0 * float(((s - dc) * ac).sum()) / den
            out.append(int(max(-16, min(16, round(a)))))
        self.restore(cur)
        return tuple(out)

    # ---- transform blocks ---------------------------------------------------
    def before_coeffs(self, rec):
        plane, x, y, tx, b = rec[:5]
        mode = b.uv_mode if plane else b.y_mode
        # the block's first transform: its prediction may be preselect's
        cached = self.pred_cache.get((plane, DC_PRED if mode == UV_CFL
                                      else mode, tx)) \
            if rec[9] == rec[10] == 0 else None
        if cached is None:
            self.rc.predict_intra(rec)
        else:
            self.rc.planes[plane][y:y + cached.shape[0],
                                  x:x + cached.shape[1]] = cached
            if mode == UV_CFL:
                self.rc.cfl(b, plane, x, y, tx, rec[12])
        self.cplan = None
        if b.skip:
            return
        d = self.d
        h, w = TXH[tx], TXW[tx]
        pred = self.rc.planes[plane][y:y + h, x:x + w]
        resid = (self.src[plane][y:y + h, x:x + w] - pred).astype(
            np.int64)[None]
        plan = self.plans[(b.row, b.col, b.size)]
        if plane:
            types = (self.plane_tx_type(b, plane, tx, None),)
        elif (x, y) in plan.txt:
            types = (plan.txt[(x, y)],)
        else:
            types = self.luma_types(b, tx)
        qml = d.seg_qm[plane][b.seg]
        tried = []
        scale2 = coefficient_scale(tx) ** 2
        weight = CHROMA_WEIGHT if plane else 1.0
        for t in types:
            coef = forward_transform(resid, tx, t)
            q = quantizers(tx, plane, b.qindex, d.dq[plane], qml, t, d.bd)
            lev = quantize(coef, tx, q, ROUNDING)[0]
            scan = _scan_info(tx, t)[0]
            flat = lev.reshape(-1)
            nz = np.flatnonzero(flat[scan])
            eob = int(nz[-1]) + 1 if nz.size else 0
            cp = (t, flat.tolist(), eob)
            self.qs[t] = (lev, q)
            if len(types) == 1:
                tried.append((0.0, 0.0, cp))
                break
            shift = (w * h > 256) + (w * h > 1024)
            ah, aw = lev.shape
            a = np.abs(lev)
            deq = (a * q) >> shift
            err = (np.abs(coef[0, :ah, :aw]) - deq).astype(np.float64)
            dist = float((err * err).sum()) / scale2 * weight
            # a rate guess: ~3 bits a nonzero level and 2 per doubling
            guess = float(np.count_nonzero(a)) * 3.0 + 2.0 * float(
                np.log2(a[a > 0]).sum()) + 0.5 * eob
            tried.append((dist + self.lam * guess, dist, cp))
        tried.sort(key=lambda t: t[0])
        best = None
        if len(tried) == 1:
            best = tried[0][1:]
        else:
            for _, dist, cp in tried[:2]:
                cost = dist + self.lam * self.coeff_bits(b, plane, x, y, tx,
                                                         cp)
                if best is None or cost < best[0]:
                    best = (cost, cp)
        self.cplan = best[1]
        self.chosen = self.qs[best[1][0]]
        if plane == 0:
            plan.txt[(x, y)] = best[1][0]
        if best[1][2]:
            self.nonzero += 1

    def luma_types(self, b, tx):
        """The luma transform types of the block's set."""
        if self.d.qidx(b.seg, None) == 0:
            return (DCT_DCT,)
        return _IN_SET[self.tx_set(b, tx)]

    def coeff_bits(self, b, plane, x, y, tx, cp):
        """The bits of coding `cp` here, against this block's contexts."""
        x4, y4 = x >> 2, y >> 2
        w4, h4 = TXW[tx] >> 2, TXH[tx] >> 2
        al, ad = self.above_level[plane], self.above_dc[plane]
        ll, ld = self.left_level[plane], self.left_dc[plane]
        saved = (al[x4:x4 + w4], ad[x4:x4 + w4], ll[y4:y4 + h4],
                 ld[y4:y4 + h4])
        sd, cplan = self.sd, self.cplan
        self.sd = counter = SymbolCounter()
        self.cplan = cp
        self.coeffs(b, plane, x, y, tx)
        self.sd, self.cplan = sd, cplan
        al[x4:x4 + w4], ad[x4:x4 + w4], ll[y4:y4 + h4], ld[y4:y4 + h4] = \
            saved
        return counter.bits

    def after_coeffs(self, rec):
        plane, x, y, tx, b = rec[:5]
        h, w = TXH[tx], TXW[tx]
        buf = self.rc.planes[plane]
        if rec[11] is not None:
            if self.searching:
                lev, q = self.chosen
                res = inverse_estimate(dequantize(lev[None], tx, q,
                                                  self.d.bd), tx,
                                       rec[11][0])[0]
            else:
                res = residuals([rec[11]], [plane], tx, False, self.d.bd)[0]
            v = buf[y:y + h, x:x + w] + res
            np.clip(v, 0, (1 << self.d.bd) - 1, out=v)
            buf[y:y + h, x:x + w] = v
        if self.searching:
            ph, pw = self.vis[plane]
            y1, x1 = min(y + h, ph), min(x + w, pw)
            if y1 > y and x1 > x:
                e = (buf[y:y1, x:x1] - self.src[plane][y:y1, x:x1]).astype(
                    np.int64)
                self.dist += float((e * e).sum()) * (
                    CHROMA_WEIGHT if plane else 1.0)
        self.cplan = None


# ---- loop filters -----------------------------------------------------------
def choose_filters(d, recon, src, vis):
    """Deblocking levels, then the CDEF strengths, each the one of its
    candidates whose filtered plane lies nearest the source (coarse steps,
    then the neighbours of the best); sets them on `d` and returns the
    filtered planes, as av1_filters filters them for the decoder."""
    from .av1_filters import cdef, deblock

    def err(planes, p):
        ph, pw = vis[p]
        e = (planes[p][:ph, :pw] - src[p][:ph, :pw]).astype(np.int64)
        return float((e * e).sum())

    def refine(score, coarse, step, lo, hi):
        got = {v: score(v) for v in coarse}
        best = min(got, key=got.get)
        while step:
            for v in (best - step, best + step):
                if lo <= v <= hi and v not in got:
                    got[v] = score(v)
            best = min(got, key=got.get)
            step //= 2
        return best

    def deblocked(levels, p):
        d.lf_level = list(levels)
        planes = [q.copy() if i == p else q for i, q in enumerate(recon)]
        if levels[0] or levels[1]:
            deblock(d, planes, only=(p,))
        return err(planes, p)

    ly = refine(lambda v: deblocked((v, v, 0, 0), 0), (0, 8, 16, 24, 32),
                4, 0, 63)
    lu = lv = 0
    if ly:
        lu = refine(lambda v: deblocked((ly, ly, v, 0), 1), (0, 8, 16, 24),
                    4, 0, 63)
        lv = refine(lambda v: deblocked((ly, ly, 0, v), 2), (0, 8, 16, 24),
                    4, 0, 63)
    d.lf_level = [ly, ly, lu, lv]
    base = [q.copy() for q in recon]
    if ly:
        deblock(d, base)
    d.cdef_damping = CDEF_DAMPING

    def cdefed(y, uv, planes):
        d.cdef_y, d.cdef_uv = [y], [uv]
        out = cdef(d, base, only=planes)
        return sum(err(out, p) for p in planes)

    pri = refine(lambda v: cdefed((v, 0), (0, 0), (0,)), (0, 2, 4, 8), 1,
                 0, 15)
    sec = min((0, 1, 2, 4), key=lambda v: cdefed((pri, v), (0, 0), (0,)))
    upri = refine(lambda v: cdefed((pri, sec), (v, 0), (1, 2)), (0, 2, 4),
                  1, 0, 15)
    usec = min((0, 1, 2), key=lambda v: cdefed((pri, sec), (upri, v),
                                                 (1, 2)))
    d.cdef_y, d.cdef_uv = [(pri, sec)], [(upri, usec)]
    return cdef(d, base)


# ---- the stream -------------------------------------------------------------
class Encoded:
    """An encoded picture: `obus` (temporal delimiter, sequence header,
    frame), `seq` (the sequence header OBU, for av1C), and `planes`, the
    reconstruction every decoder reads from it (int32 Y, U, V, cropped)."""


def tile_group(tiles) -> tuple:
    """(the tile group's bytes after the frame header, tile_size_bytes,
    the largest tile's index) as libaom writes them: with more than one
    tile, tile_start_and_end_present_flag 0 and each tile but the last
    led by its size less one in the fewest bytes the largest tile's size
    needs."""
    if len(tiles) == 1:
        return tiles[0], 4, 0
    largest = max(len(t) for t in tiles)
    size_bytes = max(1, (largest.bit_length() + 7) // 8)
    out = bytearray([0])            # the flag, then byte alignment
    for t in tiles[:-1]:
        out += (len(t) - 1).to_bytes(size_bytes, "little") + t
    out += tiles[-1]
    return bytes(out), size_bytes, [len(t) for t in tiles].index(largest)


def encode_yuv420(y, u, v) -> Encoded:
    """Codes 8-bit Y [h, w], U and V [(h + 1) // 2, (w + 1) // 2]."""
    return encode_frame((y, u, v))


def _downscale(plane: np.ndarray, width: int) -> np.ndarray:
    """A plane resampled to `width` columns, linearly, rounded (the
    superres encoder's source: any filter does, as only the decode is
    normative)."""
    n = plane.shape[1]
    x = (np.arange(width) + 0.5) * n / width - 0.5
    rows = [np.interp(x, np.arange(n), r) for r in plane.astype(np.float64)]
    return np.rint(np.array(rows)).astype(np.int32)


def lr_units(d, seed: int) -> dict:
    """Random loop restoration units {(plane, unit row, unit column):
    unit} for every unit of the frame state `d`, within each plane's
    frame restoration type (the unit types RESTORE_NONE, _WIENER and
    _SGRPROJ; Wiener taps and self-guided sets and weights in their
    ranges)."""
    from .av1 import (RESTORE_SGRPROJ, RESTORE_SWITCHABLE, RESTORE_WIENER,
                      SGR_MAX, SGR_MIN, WIENER_MAX, WIENER_MIN)
    rng = np.random.default_rng(seed)
    plan = {}
    for p in range(d.nplanes):
        t = d.lr_type[p]
        if not t:
            continue
        sx, sy = (d.ssx, d.ssy) if p else (0, 0)
        size = d.lr_size[p]
        rows = max((((d.h + sy) >> sy) + (size >> 1)) // size, 1)
        cols = max((((d.up_w + sx) >> sx) + (size >> 1)) // size, 1)
        for ur in range(rows):
            for uc in range(cols):
                kind = int(rng.integers(3)) if t == RESTORE_SWITCHABLE \
                    else t * int(rng.integers(4) > 0)
                if kind == RESTORE_WIENER:
                    taps = [[0 if (p and j == 0) else int(rng.integers(
                        WIENER_MIN[j], WIENER_MAX[j] + 1)) for j in range(3)]
                        for _ in range(2)]
                    plan[(p, ur, uc)] = (kind, taps)
                elif kind == RESTORE_SGRPROJ:
                    plan[(p, ur, uc)] = (kind, int(rng.integers(16)), [
                        int(rng.integers(SGR_MIN[i], SGR_MAX[i] + 1))
                        for i in range(2)])
                else:
                    plan[(p, ur, uc)] = (0,)
    return plan


def encode_frame(planes, o: Options = DEFAULT) -> Encoded:
    """Codes the planes (Y [h, w], U and V at the subsampling of `o`, of
    o.bd bits) as one key frame with what `o` switches on. With superres
    the planes are resampled to the coded width first (`_downscale`), and
    `planes` of the result are the decode at the full width."""
    y = planes[0]
    h, W = y.shape
    w = coded_width(W, o.superres) if o.superres != 8 else W
    src_planes = [np.asarray(pl, np.int32) for pl in planes]
    if w != W:
        src_planes = [_downscale(pl, (w + (o.ssx if i else 0)) >>
                                 (o.ssx if i else 0))
                      for i, pl in enumerate(src_planes)]
    seq = sequence_header(W, h, o)
    sb_q = {}
    for r in range(0, 2 * ((h + 7) >> 3), 16):
        for c in range(0, 2 * ((w + 7) >> 3), 16):
            sb_q[(r, c)] = sb_qindex(src_planes[0] >> (o.bd - 8), w, h, r,
                                     c)
    # as libaom, no delta q where every superblock keeps base_q_idx
    delta_q = int(any(q != BASE_Q for q in sb_q.values()))
    d = frame_state(seq, frame_header(w, h, (0, 0, 0, 0), (0, 0), (0, 0),
                                      delta_q, o=o))
    plan = lr_units(d, o.lr["seed"]) if o.lr is not None else None
    rc = Recon(d)
    source = padded_source(rc, src_planes)
    tiles = []
    for r0, r1 in zip(d.row_starts, d.row_starts[1:]):
        for c0, c1 in zip(d.col_starts, d.col_starts[1:]):
            te = TileEncoder(d, rc, source, sb_q, r0, r1, c0, c1)
            te.lr_plan = plan
            tiles.append(te.encode())
    src, vis = source
    planes = choose_filters(d, list(rc.planes), src, vis)
    body, size_bytes, largest = tile_group(tiles)
    hdr = frame_header(w, h, d.lf_level, d.cdef_y[0], d.cdef_uv[0],
                       delta_q, largest, size_bytes, o)
    out = Encoded()
    out.seq = _obu(1, seq)
    out.obus = _obu(2, b"") + out.seq + _obu(6, hdr + body)
    if o.hidden:
        out.obus += _obu(3, show_existing_header(0))
    if w != W or o.lr is not None or o.grain is not None or o.hidden:
        from .av1 import decode_av1
        out.planes = decode_av1(out.obus).planes
    else:
        out.planes = [p[:ph, :pw].copy() for p, (ph, pw) in zip(planes, vis)]
    return out
