"""AV1 intra block copy: the displacement vector of an `intrabc` block
(the reference MV stack of spec 7.10.2 for the INTRA_FRAME reference,
the MV syntax under MV_INTRABC_CONTEXT), the variable transform sizes of
such a block (`read_var_tx_size`) and its prediction, a BILINEAR copy
from the frame decoded so far (spec 7.11.3)."""
from __future__ import annotations

import copy

import numpy as np

from . import av1_tables as T

MV_BORDER = 128
REF_CAT_LEVEL = 640
INTRABC_DELAY_PIXELS = 256


def _cdf(values):
    return list(values) + [32768, 0]


def MV_CDFS():
    """Default MV and transform-split CDFs, one MV set per MvCtx (0 and
    MV_INTRABC_CONTEXT) and component."""
    comp = {"class": _cdf(T.MV_CLASS), "sign": _cdf(T.MV_SIGN),
            "class0": _cdf(T.MV_CLASS0_BIT),
            "bits": [_cdf(b) for b in T.MV_BIT]}
    ctx = {"joint": _cdf(T.MV_JOINT), "comp": [copy.deepcopy(comp),
                                               copy.deepcopy(comp)]}
    return {"MV": [copy.deepcopy(ctx), copy.deepcopy(ctx)],
            "TXFM_SPLIT": [_cdf(c) for c in T.TXFM_SPLIT]}


# ---- the reference MV stack (single reference INTRA_FRAME) ---------------
class _Stack:
    def __init__(self):
        self.mvs, self.weights = [], []

    def add(self, mv, weight):
        for i, m in enumerate(self.mvs):
            if m == mv:
                self.weights[i] += weight
                return
        if len(self.mvs) < 8:
            self.mvs.append(mv)
            self.weights.append(weight)


def _candidate(td, stack, r, c, weight):
    b = td.d.mi[r][c]
    if b is None or not b.is_inter:
        return
    # an intrabc block's reference is INTRA_FRAME, as is the current one;
    # its vector is integer, so lowering the precision changes nothing
    stack.add(b.mv, weight)


def _scan_row(td, stack, b, delta_row):
    from .av1 import BW4
    d = td.d
    bw4 = BW4[b.size]
    end4 = min(bw4, d.mi_cols - b.col, 16)
    delta_col = 0
    step16 = bw4 >= 16
    if abs(delta_row) > 1:
        delta_row += b.row & 1
        delta_col = 1 - (b.col & 1)
    i = 0
    while i < end4:
        r, c = b.row + delta_row, b.col + delta_col + i
        if not td.inside(r, c):
            break
        ln = min(bw4, BW4[d.mi[r][c].size])
        if abs(delta_row) > 1:
            ln = max(2, ln)
        if step16:
            ln = max(4, ln)
        _candidate(td, stack, r, c, ln * 2)
        i += ln


def _scan_col(td, stack, b, delta_col):
    from .av1 import BH4
    d = td.d
    bh4 = BH4[b.size]
    end4 = min(bh4, d.mi_rows - b.row, 16)
    delta_row = 0
    step16 = bh4 >= 16
    if abs(delta_col) > 1:
        delta_row = 1 - (b.row & 1)
        delta_col += b.col & 1
    i = 0
    while i < end4:
        r, c = b.row + delta_row + i, b.col + delta_col
        if not td.inside(r, c):
            break
        ln = min(bh4, BH4[d.mi[r][c].size])
        if abs(delta_col) > 1:
            ln = max(2, ln)
        if step16:
            ln = max(4, ln)
        _candidate(td, stack, r, c, ln * 2)
        i += ln


def _scan_point(td, stack, b, dr, dc):
    r, c = b.row + dr, b.col + dc
    if td.inside(r, c) and td.d.mi[r][c] is not None:
        _candidate(td, stack, r, c, 4)


def _sort(stack, start, end):
    w, m = stack.weights, stack.mvs
    while end > start:
        new_end = start
        for i in range(start + 1, end):
            if w[i - 1] < w[i]:
                w[i - 1], w[i] = w[i], w[i - 1]
                m[i - 1], m[i] = m[i], m[i - 1]
                new_end = i
        end = new_end


def ref_mv_stack(td, b):
    """RefStackMv[0 .. 1][0] of an intrabc block (find_mv_stack)."""
    from .av1 import BH4, BW4
    d = td.d
    bw4, bh4 = BW4[b.size], BH4[b.size]
    st = _Stack()
    _scan_row(td, st, b, -1)
    _scan_col(td, st, b, -1)
    if max(bw4, bh4) <= 16:
        _scan_point(td, st, b, -1, bw4)
    n_nearest = len(st.mvs)
    for i in range(n_nearest):
        st.weights[i] += REF_CAT_LEVEL
    _scan_point(td, st, b, -1, -1)
    _scan_row(td, st, b, -3)
    _scan_col(td, st, b, -3)
    if bh4 > 1:
        _scan_row(td, st, b, -5)
    if bw4 > 1:
        _scan_col(td, st, b, -5)
    _sort(st, 0, n_nearest)
    _sort(st, n_nearest, len(st.mvs))
    # (extra_search adds nothing: no candidate references an inter frame)
    out = []
    for mv in st.mvs[:2]:
        top = -(b.row * 4 * 8)
        bottom = (d.mi_rows - bh4 - b.row) * 4 * 8
        lft = -(b.col * 4 * 8)
        rgt = (d.mi_cols - bw4 - b.col) * 4 * 8
        br, bc = MV_BORDER + bh4 * 4 * 8, MV_BORDER + bw4 * 4 * 8
        out.append((min(max(mv[0], top - br), bottom + br),
                    min(max(mv[1], lft - bc), rgt + bc)))
    while len(out) < 2:
        out.append((0, 0))
    return out


def _read_component(sd, cdfs):
    sign = sd.symbol(cdfs["sign"])
    cls = sd.symbol(cdfs["class"])
    if cls == 0:
        mag = ((sd.symbol(cdfs["class0"]) << 3) | (3 << 1) | 1) + 1
    else:
        dd = 0
        for i in range(cls):
            dd |= sd.symbol(cdfs["bits"][i]) << i
        mag = (2 << (cls + 2)) + ((dd << 3) | (3 << 1) | 1) + 1
    return -mag if sign else mag


def intrabc_mv(td, b, r, c):
    """The block's displacement (row, col) in 1/8 pixel units."""
    from .av1 import BH4
    stack = ref_mv_stack(td, b)
    pred = stack[0]
    if pred == (0, 0):
        pred = stack[1]
    if pred == (0, 0):
        sb4 = BH4[15] if td.sb4 == 32 else BH4[12]
        if r - sb4 < td.r0:
            pred = (0, -(sb4 * 4 + INTRABC_DELAY_PIXELS) * 8)
        else:
            pred = (-(sb4 * 4 * 8), 0)
    pred = ((pred[0] >> 3) * 8, (pred[1] >> 3) * 8)
    sd = td.sd
    ctx = td.cdf["MV"][1]
    joint = sd.symbol(ctx["joint"])
    dr = _read_component(sd, ctx["comp"][0]) if joint in (2, 3) else 0
    dc = _read_component(sd, ctx["comp"][1]) if joint in (1, 3) else 0
    return (pred[0] + dr, pred[1] + dc)


# ---- variable transform sizes -----------------------------------------------
def read_var_tx_size(td, b, r, c):
    """Reads the transform partition of an inter (intrabc) block; records
    its transforms in b.var_tx as (tx size, x4, y4) in decode order and
    returns the last size read."""
    from .av1 import (BH4, BW4, MAX_TX_RECT, SPLIT_TX, TXH, TXW, TX_SQR_UP,
                      _TXSIZE)
    d = td.d
    bsize = b.size
    mx = MAX_TX_RECT[bsize]
    b.var_tx = []
    size = min(64, max(4 * BW4[bsize], 4 * BH4[bsize]))
    max_sq = _TXSIZE[(size, size)]
    last = [mx]

    def above_w(row, col):
        if row == b.row:
            if not b.avail[0]:
                return 64
            a = d.mi[row - 1][col]
            if a.skip and a.is_inter:
                return 4 * BW4[a.size]
        return TXW[d.inter_tx[row - 1][col]]

    def left_h(row, col):
        if col == b.col:
            if not b.avail[1]:
                return 64
            a = d.mi[row][col - 1]
            if a.skip and a.is_inter:
                return 4 * BH4[a.size]
        return TXH[d.inter_tx[row][col - 1]]

    def rec(row, col, tx, depth):
        if row >= d.mi_rows or col >= d.mi_cols:
            return
        if tx == 0 or depth == 2:
            split = 0
        else:
            ctx = ((TX_SQR_UP[tx] != max_sq) * 3 + (4 - max_sq) * 6 +
                   (above_w(row, col) < TXW[tx]) +
                   (left_h(row, col) < TXH[tx]))
            split = td.sd.symbol(td.cdf["TXFM_SPLIT"][ctx])
        w4, h4 = TXW[tx] >> 2, TXH[tx] >> 2
        if split:
            sub = SPLIT_TX[tx]
            sw, sh = TXW[sub] >> 2, TXH[sub] >> 2
            for i in range(0, h4, sh):
                for j in range(0, w4, sw):
                    rec(row + i, col + j, sub, depth + 1)
        else:
            for i in range(h4):
                if row + i < d.mi_rows:
                    line = d.inter_tx[row + i]
                    for j in range(w4):
                        if col + j < d.mi_cols:
                            line[col + j] = tx
            b.var_tx.append((tx, col - b.col, row - b.row))
            last[0] = tx
    w4, h4 = TXW[mx] >> 2, TXH[mx] >> 2
    for row in range(r, r + BH4[bsize], h4):
        for col in range(c, c + BW4[bsize], w4):
            rec(row, col, mx, 0)
    return last[0]


# ---- prediction -------------------------------------------------------------
def predict_intrabc(rc, b, plane):
    """Writes the block's BILINEAR copy from the frame decoded so far."""
    from .av1 import BH4, BW4
    d = rc.d
    sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
    w4 = max(BW4[b.size] >> sx, 1)
    h4 = max(BH4[b.size] >> sy, 1)
    w, h = 4 * w4, 4 * h4
    x, y = (b.col >> sx) * 4, (b.row >> sy) * 4
    buf = rc.planes[plane]
    # libaom extends no border for intra block copy: a valid vector may
    # reach the decoded samples past the frame's width and height (up to
    # the 8-aligned size of the mode info), and they are read as they are
    last_x = ((d.mi_cols * 4) >> sx) - 1
    last_y = ((d.mi_rows * 4) >> sy) - 1
    # position in 1/16 sample (no scaling, so the 1/1024 steps are exact)
    px = (x << 4) + ((2 * b.mv[1]) >> sx)
    py = (y << 4) + ((2 * b.mv[0]) >> sy)
    r0 = 5 if d.bd == 12 else 3
    r1 = 9 if d.bd == 12 else 11
    fx, fy = px & 15, py & 15
    ix, iy = px >> 4, py >> 4
    cols = np.clip(ix + np.arange(w + 1), 0, last_x)
    rows = np.clip(iy + np.arange(h + 1), 0, last_y)
    src = buf[rows[:, None], cols[None, :]].astype(np.int64)
    # BILINEAR taps at phase p: 128 - 8p at the sample, 8p at the next
    hor = ((128 - 8 * fx) * src[:, :w] + 8 * fx * src[:, 1:w + 1] +
           (1 << (r0 - 1))) >> r0
    ver = ((128 - 8 * fy) * hor[:h] + 8 * fy * hor[1:h + 1] +
           (1 << (r1 - 1))) >> r1
    buf[y:y + h, x:x + w] = np.clip(ver, 0, (1 << d.bd) - 1)
