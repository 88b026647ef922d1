"""AV1 inter prediction (spec 7.11.3) on whole blocks with numpy: motion
vector scaling, the sub-pixel filters (with the 4-tap ones for sides of
4 or less), local and global warps (setupShear, warp estimation, the
8 x 8 warp filter with libaom's parameter reduction), compound
averages, distance weights, wedge, difference-weighted and smooth
inter-intra masks, the mask blend and overlapped block motion
compensation. A block's prediction is written into the frame being
reconstructed (Recon.planes) before its residual, in decode order; the
reference frames are the slots' planes, before film grain.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T
from .av1 import (_BSIZE, BH4, BW4, COMPOUND_AVERAGE,
                  COMPOUND_DIFFWTD, COMPOUND_DISTANCE, COMPOUND_INTRA,
                  COMPOUND_WEDGE, DC_PRED, EIGHTTAP, EIGHTTAP_SHARP,
                  EIGHTTAP_SMOOTH, GLOBAL_GLOBALMV, GLOBALMV, H_PRED,
                  INTRA_FRAME, LOCALWARP, OBMC, SMOOTH, TRANSLATION, V_PRED,
                  _TXSIZE)

SUBPEL = np.array(T.SUBPEL_FILTERS, np.int64)
WARPED = np.array(T.WARPED_FILTERS, np.int64)
II_WEIGHTS = np.array(T.II_WEIGHTS_1D, np.int64)
_WEDGE = {}


def _round2(v, n):
    return (v + (1 << (n - 1))) >> n if n else v


def _round2s(v, n):
    return (v + (1 << (n - 1))) >> n if v >= 0 else \
        -((-v + (1 << (n - 1))) >> n)


# ---- warps (7.11.3.6, 7.11.3.8) -----------------------------------------
def resolve_divisor(d):
    """(divShift, divFactor) of resolve_divisor for a nonzero d."""
    n = abs(d).bit_length() - 1
    e = abs(d) - (1 << n)
    f = _round2(e, n - 8) if n > 8 else e << (8 - n)
    factor = T.DIV_LUT[f]
    return n + 14, -factor if d < 0 else factor


def setup_shear(p):
    """(alpha, beta, gamma, delta, warpValid) of warp parameters p, as
    libaom's av1_get_shear_params (which also refuses p[2] <= 0)."""
    if p[2] <= 0:
        return 0, 0, 0, 0, False

    def c16(v):
        return max(-32768, min(32767, v))
    alpha0 = c16(p[2] - (1 << 16))
    beta0 = c16(p[3])
    shift, factor = resolve_divisor(p[2])
    gamma0 = c16(_round2s((p[4] << 16) * factor, shift))
    delta0 = c16(p[5] - _round2s(p[3] * p[4] * factor, shift) - (1 << 16))
    a, b, g, d = (_round2s(v, 6) << 6 for v in (alpha0, beta0, gamma0,
                                                 delta0))
    valid = 4 * abs(a) + 7 * abs(b) < (1 << 16) and \
        4 * abs(g) + 4 * abs(d) < (1 << 16)
    return a, b, g, d, valid


def warp_estimation(b, samples):
    """LocalWarpParams from the block's warp samples (7.11.3.8), or None
    where the system has no solution (LocalValid 0)."""
    A = [[0, 0], [0, 0]]
    bx, by = [0, 0], [0, 0]
    bw, bh = 4 * BW4[b.size], 4 * BH4[b.size]
    mid_y = b.row * 4 + bh // 2 - 1
    mid_x = b.col * 4 + bw // 2 - 1
    suy, sux = mid_y * 8, mid_x * 8
    mv = b.mv[0]
    duy, dux = suy + mv[0], sux + mv[1]

    def ls(a, c):
        return ((a * c) >> 2) + (a + c)
    for cy, cx, ry, rx in samples:
        sy, sx = cy - suy, cx - sux
        dy, dx = ry - duy, rx - dux
        if abs(sx - dx) < 256 and abs(sy - dy) < 256:
            A[0][0] += ls(sx, sx) + 8
            A[0][1] += ls(sx, sy) + 4
            A[1][1] += ls(sy, sy) + 8
            bx[0] += ls(sx, dx) + 8
            bx[1] += ls(sy, dx) + 4
            by[0] += ls(sx, dy) + 4
            by[1] += ls(sy, dy) + 8
    det = A[0][0] * A[1][1] - A[0][1] * A[0][1]
    if det == 0:
        return None
    shift, factor = resolve_divisor(det)
    shift -= 16
    if shift < 0:
        factor <<= -shift
        shift = 0

    def diag(v):
        return max((1 << 16) - (1 << 13) + 1, min((1 << 16) + (1 << 13) - 1,
                                                  _round2s(v * factor,
                                                           shift)))

    def nondiag(v):
        return max(-(1 << 13) + 1, min((1 << 13) - 1,
                                       _round2s(v * factor, shift)))
    p = [0] * 6
    p[2] = diag(A[1][1] * bx[0] - A[0][1] * bx[1])
    p[3] = nondiag(-A[0][1] * bx[0] + A[0][0] * bx[1])
    p[4] = nondiag(A[1][1] * by[0] - A[0][1] * by[1])
    p[5] = diag(-A[0][1] * by[0] + A[0][0] * by[1])
    vx = mv[1] * (1 << 13) - (mid_x * (p[2] - (1 << 16)) + mid_y * p[3])
    vy = mv[0] * (1 << 13) - (mid_x * p[4] + mid_y * (p[5] - (1 << 16)))
    clamp = 1 << 23
    p[0] = max(-clamp, min(clamp - 1, vx))
    p[1] = max(-clamp, min(clamp - 1, vy))
    return p


def block_warp(ref, params, shear, x, y, w, h, sx, sy, last_x, last_y, r0,
               r1):
    """The warped prediction [h, w] (7.11.3.5) of the plane block at
    (x, y): every 8 x 8 of it at once, each filtered about its own
    centre's position."""
    alpha, beta, gamma, delta = shear[:4]
    ni, nj = (h + 7) // 8, (w + 7) // 8
    k = np.arange(-7, 8)
    l8 = np.arange(-4, 4)
    t8 = np.arange(8)
    src_x = ((x + 8 * np.arange(nj, dtype=np.int64) + 4) << sx)[None, :]
    src_y = ((y + 8 * np.arange(ni, dtype=np.int64) + 4) << sy)[:, None]
    x4 = (params[2] * src_x + params[3] * src_y + params[0]) >> sx
    y4 = (params[4] * src_x + params[5] * src_y + params[1]) >> sy
    ix4, iy4 = x4 >> 16, y4 >> 16                           # [ni, nj]
    # libaom drops the low WARP_PARAM_REDUCE_BITS of the phases
    sx4 = (x4 & 0xffff) & ~63
    sy4 = (y4 & 0xffff) & ~63
    phx = sx4[..., None, None] + alpha * l8 + beta * k[:, None]
    offs = ((phx + 512) >> 10) + 64                        # [ni,nj,15,8]
    rows = np.clip(iy4[..., None] + k, 0, last_y)          # [ni,nj,15]
    cols = np.clip(ix4[..., None, None] + l8[:, None] - 3 + t8, 0,
                   last_x)                                 # [ni,nj,8,8]
    src = ref[rows[..., :, None, None], cols[..., None, :, :]].astype(
        np.int64)                                          # [ni,nj,15,8,8]
    inter = _round2((src * WARPED[offs]).sum(-1), r0)      # [ni,nj,15,8]
    phy = sy4[..., None, None] + gamma * l8 + delta * l8[:, None]
    offs = ((phy + 512) >> 10) + 64                        # [ni,nj,8,8]
    g = inter[:, :, (l8[:, None] + 4) + t8[None, :]]       # [ni,nj,8,8t,8]
    s = _round2(np.einsum("ijabt,ijatb->ijab", WARPED[offs], g), r1)
    out = s.transpose(0, 2, 1, 3).reshape(ni * 8, nj * 8)
    return out[:h, :w]


# ---- translational prediction (7.11.3.3, 7.11.3.4) ----------------------
def filter_index(f, size):
    """The Subpel_Filters row of interpolation filter f along a side of
    `size` samples."""
    if size <= 4:
        if f in (EIGHTTAP, EIGHTTAP_SHARP):
            return 4
        if f == EIGHTTAP_SMOOTH:
            return 5
    return f


def scale_factors(d, slot):
    """(xScale, yScale) of a reference frame's saved state."""
    xs = ((slot["up_w"] << 14) + d.w // 2) // d.w
    ys = ((slot["h"] << 14) + d.h // 2) // d.h
    return xs, ys


def block_pred(d, ref, slot, plane, x, y, w, h, mv, interp, r0, r1):
    """The prediction [h, w] (before InterPostRound) of the plane block at
    (x, y) from reference planes `ref` along mv (row, col) with filters
    interp (vertical, horizontal)."""
    sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
    last_x = ((slot["up_w"] + sx) >> sx) - 1
    last_y = ((slot["h"] + sy) >> sy) - 1
    xs, ys = scale_factors(d, slot)
    ox = (x << 4) + ((2 * mv[1]) >> sx) + 8
    oy = (y << 4) + ((2 * mv[0]) >> sy) + 8
    start_x = _round2s(ox * xs - (8 << 14), 8) + 32
    start_y = _round2s(oy * ys - (8 << 14), 8) + 32
    step_x, step_y = _round2s(xs, 4), _round2s(ys, 4)
    fx = SUBPEL[filter_index(interp[1], w)]
    fy = SUBPEL[filter_index(interp[0], h)]
    ih = (((h - 1) * step_y + (1 << 10) - 1) >> 10) + 8
    t8 = np.arange(8)
    rows = np.clip((start_y >> 10) + np.arange(ih) - 3, 0, last_y)
    px = start_x + step_x * np.arange(w, dtype=np.int64)
    cols = np.clip((px >> 10)[:, None] + t8[None, :] - 3, 0, last_x)
    src = ref[rows[:, None, None], cols[None]].astype(np.int64)  # [ih,w,8]
    inter = _round2((src * fx[(px >> 6) & 15][None]).sum(-1), r0)
    py = (start_y & 1023) + step_y * np.arange(h, dtype=np.int64)
    g = inter[(py >> 10)[:, None] + t8[None, :]]                 # [h, 8, w]
    s = (g * fy[(py >> 6) & 15][:, :, None]).sum(1)
    return _round2(s, r1)


# ---- masks (7.11.3.11-7.11.3.15) ----------------------------------------
def _master_masks():
    """MasterMask[direction] (7.11.3.11), 64 x 64 each."""
    even = np.array(T.WEDGE_MASTER_OBLIQUE_EVEN, np.int64)
    odd = np.array(T.WEDGE_MASTER_OBLIQUE_ODD, np.int64)
    vert = np.array(T.WEDGE_MASTER_VERTICAL, np.int64)
    m = np.zeros((6, 64, 64), np.int64)
    j = np.arange(64)
    for i in range(0, 64, 2):
        shift = 16 - i // 2
        m[3, i] = even[np.clip(j - shift, 0, 63)]
        m[3, i + 1] = odd[np.clip(j - shift + 1, 0, 63)]
        m[1, i] = m[1, i + 1] = vert
    obl = m[3].copy()
    m[2] = obl.T
    m[4] = 64 - obl[:, ::-1]
    m[5] = (64 - obl).T[::-1]
    m[0] = m[1].T
    return m


def wedge_mask(bsize, sign, index):
    """WedgeMasks[bsize][sign][index] (7.11.3.11), [h, w]."""
    key = (bsize, sign, index)
    if key not in _WEDGE:
        if "master" not in _WEDGE:
            _WEDGE["master"] = _master_masks()
        w, h = 4 * BW4[bsize], 4 * BH4[bsize]
        shape = 0 if h > w else 1 if h < w else 2
        direction, xo, yo = T.WEDGE_CODEBOOK[shape][index]
        xoff = 32 - ((xo * w) >> 3)
        yoff = 32 - ((yo * h) >> 3)
        m = _WEDGE["master"][direction, yoff:yoff + h, xoff:xoff + w]
        flip = T.WEDGE_SIGNFLIP[bsize][index]
        _WEDGE[key] = m.copy() if sign == flip else 64 - m
    return _WEDGE[key]


def wedge_sign_flip(bsize, index):
    """The specification's flipSign of a wedge: whether the average of
    the mask's first row and column is under 32."""
    if "master" not in _WEDGE:
        _WEDGE["master"] = _master_masks()
    w, h = 4 * BW4[bsize], 4 * BH4[bsize]
    shape = 0 if h > w else 1 if h < w else 2
    direction, xo, yo = T.WEDGE_CODEBOOK[shape][index]
    m = _WEDGE["master"][direction, 32 - ((yo * h) >> 3):,
                         32 - ((xo * w) >> 3):]
    s = int(m[0, :w].sum() + m[1:h, 0].sum())
    return int((s + (w + h - 1) // 2) // (w + h - 1) < 32)


def ii_smooth_mask(mode, w, h):
    """The inter-intra mask of II_V/H/SMOOTH/DC_PRED (7.11.3.13)."""
    scale = 128 // max(w, h)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if mode == 1:
        return np.broadcast_to(II_WEIGHTS[i * scale], (h, w))
    if mode == 2:
        return np.broadcast_to(II_WEIGHTS[j * scale], (h, w))
    if mode == 3:
        return II_WEIGHTS[np.minimum(i, j) * scale]
    return np.full((h, w), 32, np.int64)


def distance_weights(d, cb):
    """(FwdWeight, BckWeight) of a compound block (7.11.3.15), as
    libaom's av1_dist_wtd_comp_weight_assign picks them."""
    dist = [max(0, min(31, abs(d.rel_dist(d.order_hints[cb.ref[i]],
                                          d.order_hint)))) for i in range(2)]
    d0, d1 = dist[1], dist[0]
    order = int(d0 <= d1)
    lut = T.QUANT_DIST_LOOKUP
    if d0 == 0 or d1 == 0:
        return lut[3][order], lut[3][1 - order]
    i = 0
    while i < 3:
        c0 = T.QUANT_DIST_WEIGHT[i][order]
        c1 = T.QUANT_DIST_WEIGHT[i][1 - order]
        if (order and d0 * c0 > d1 * c1) or \
                (not order and d0 * c0 < d1 * c1):
            break
        i += 1
    return lut[i][order], lut[i][1 - order]


# ---- a block ------------------------------------------------------------
class _IntraMode:
    """The mode info predict_intra reads, for an inter-intra block."""
    filter_mode = -1
    angle_y = angle_uv = 0

    def __init__(self, mode):
        self.y_mode = self.uv_mode = mode


II_MODES = (DC_PRED, V_PRED, H_PRED, SMOOTH)


def predict_inter_block(rc, b, plane):
    """compute_prediction (7.11.3 / 5.11.33's prediction part) of an
    inter block's plane: its inter-intra intra part, then each
    prediction block (a sub-8x8 chroma block predicted per luma block)."""
    d = rc.d
    sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
    pw4 = max(BW4[b.size] >> sx, 1)
    ph4 = max(BH4[b.size] >> sy, 1)
    base_x, base_y = (b.col >> sx) * 4, (b.row >> sy) * 4
    if b.interintra:
        w, h = 4 * pw4, 4 * ph4
        au, al = b.avail[2:] if plane else b.avail[:2]
        rc.predict_intra([plane, base_x, base_y, _TXSIZE[(w, h)],
                          _IntraMode(II_MODES[b.ii_mode]), al, au, 0, 0, 0,
                          0, None, None])
    cand_row, cand_col = (b.row >> sy) << sy, (b.col >> sx) << sx
    pred_w = (4 * BW4[b.size]) >> sx
    pred_h = (4 * BH4[b.size]) >> sy
    if any(d.mi[y][x].ref[0] == INTRA_FRAME
           for y in range(cand_row, min(cand_row + (ph4 << sy), d.mi_rows))
           for x in range(cand_col, min(cand_col + (pw4 << sx),
                                         d.mi_cols))):
        pred_w, pred_h = 4 * pw4, 4 * ph4
        cand_row, cand_col = b.row, b.col
    for r, y in enumerate(range(0, 4 * ph4, pred_h)):
        for c, x in enumerate(range(0, 4 * pw4, pred_w)):
            predict_inter(rc, b, plane, base_x + x, base_y + y, pred_w,
                          pred_h, cand_row + r, cand_col + c)


def _ref(d, ref):
    idx = d.ref_idx[ref - 1]
    return d.slots[idx][0], d.saved[idx]


def predict_inter(rc, b, plane, x, y, w, h, cand_row, cand_col):
    """predict_inter (7.11.3.1): the plane block at (x, y), w x h, along
    the vectors of the block at (cand_row, cand_col)."""
    from .av1_mv import is_scaled
    d = rc.d
    cb = d.mi[cand_row][cand_col]
    comp = cb.ref[1] > INTRA_FRAME
    bd = d.bd
    mx = (1 << bd) - 1
    r0 = 5 if bd == 12 else 3
    r1 = 7 if comp else (9 if bd == 12 else 11)
    post = 14 - r0 - r1
    sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
    local = None
    if b.motion_mode == LOCALWARP:         # LocalWarpParams, if valid
        p = warp_estimation(b, b.warp)
        if p is not None and setup_shear(p)[4]:
            local = (p, setup_shear(p))
    preds = []
    for lst in range(1 + comp):
        ref = cb.ref[lst]
        frame, slot = _ref(d, ref)
        rp = frame.planes[plane]
        last_x = ((slot["up_w"] + sx) >> sx) - 1
        last_y = ((slot["h"] + sy) >> sy) - 1
        warp = None
        if w >= 8 and h >= 8 and not d.force_imv:
            if local is not None:
                warp = local
            elif b.y_mode in (GLOBALMV, GLOBAL_GLOBALMV) and \
                    d.gm_type[ref] > TRANSLATION and not is_scaled(d, ref):
                sh = setup_shear(d.gm[ref])
                if sh[4]:
                    warp = (d.gm[ref], sh)
        if warp is not None:
            preds.append(block_warp(rp, warp[0], warp[1], x, y, w, h, sx,
                                    sy, last_x, last_y, r0, r1))
        else:
            preds.append(block_pred(d, rp, slot, plane, x, y, w, h,
                                    cb.mv[lst], cb.interp, r0, r1))
    buf = rc.planes[plane]
    ct = b.comp_type
    if ct == COMPOUND_WEDGE and plane == 0:
        b.mask = wedge_mask(b.size, b.wedge_sign, b.wedge_index)
    elif ct == COMPOUND_INTRA:
        b.mask = ii_smooth_mask(b.ii_mode, w, h)
    elif ct == COMPOUND_DIFFWTD and plane == 0:
        diff = _round2(np.abs(preds[0] - preds[1]), bd - 8 + post)
        m = np.clip(38 + diff // 16, 0, 64)
        b.mask = 64 - m if b.mask_type else m
    if not comp and not b.interintra:
        out = np.clip(_round2(preds[0], post), 0, mx)
    elif comp and ct == COMPOUND_AVERAGE:
        out = np.clip(_round2(preds[0] + preds[1], 1 + post), 0, mx)
    elif comp and ct == COMPOUND_DISTANCE:
        fw, bw = distance_weights(d, cb)
        out = np.clip(_round2(fw * preds[0] + bw * preds[1], 4 + post), 0,
                      mx)
    else:
        m = b.mask
        if (sx or sy) and not (b.interintra and not b.wedge_ii):
            m = m[:h << sy, :w << sx]
            if sx and sy:
                m = _round2(m[0::2, 0::2] + m[0::2, 1::2] + m[1::2, 0::2] +
                            m[1::2, 1::2], 2)
            elif sx:
                m = _round2(m[:, 0::2] + m[:, 1::2], 1)
            else:
                m = _round2(m[0::2] + m[1::2], 1)
        m = m[:h, :w]
        if b.interintra:
            p0 = np.clip(_round2(preds[0], post), 0, mx)
            p1 = buf[y:y + h, x:x + w].astype(np.int64)
            out = _round2(m * p1 + (64 - m) * p0, 6)
        else:
            out = np.clip(_round2(m * preds[0] + (64 - m) * preds[1],
                                  6 + post), 0, mx)
    buf[y:y + h, x:x + w] = out
    if b.motion_mode == OBMC:
        obmc(rc, b, plane, w, h)


def obmc(rc, b, plane, w, h):
    """The overlapped motion compensation (7.11.3.10): the above row's
    and then the left column's predictions blended into the block."""
    d = rc.d
    sx, sy = (d.ssx, d.ssy) if plane else (0, 0)
    buf = rc.planes[plane]
    mx = (1 << d.bd) - 1
    r0 = 5 if d.bd == 12 else 3
    r1 = 9 if d.bd == 12 else 11
    pw4 = max(BW4[b.size] >> sx, 1)
    ph4 = max(BH4[b.size] >> sy, 1)

    def overlap(cand, x4, y4, pw, ph, mask, pas):
        frame, slot = _ref(d, cand.ref[0])
        px, py = (x4 * 4) >> sx, (y4 * 4) >> sy
        p = block_pred(d, frame.planes[plane], slot, plane, px, py, pw, ph,
                       cand.mv[0], cand.interp, r0, r1)
        p = np.clip(p, 0, mx)
        m = np.array(mask, np.int64)
        m = m[:ph, None] if pas == 0 else m[None, :pw]
        cur = buf[py:py + ph, px:px + pw].astype(np.int64)
        buf[py:py + ph, px:px + pw] = _round2(m * cur + (64 - m) * p, 6)
    if b.avail[0] and _BSIZE[(pw4, ph4)] >= 3:
        limit = min(4, BW4[b.size].bit_length() - 1)
        n, x4 = 0, b.col
        while n < limit and x4 < min(d.mi_cols, b.col + BW4[b.size]):
            cand = d.mi[b.row - 1][x4 | 1]
            step = max(2, min(16, BW4[cand.size]))
            if cand.ref[0] > INTRA_FRAME:
                n += 1
                ph = min(h >> 1, 32 >> sy)
                overlap(cand, x4, b.row, min(w, (step * 4) >> sx), ph,
                        T.OBMC_MASK[ph], 0)
            x4 += step
    if b.avail[1]:
        limit = min(4, BH4[b.size].bit_length() - 1)
        n, y4 = 0, b.row
        while n < limit and y4 < min(d.mi_rows, b.row + BH4[b.size]):
            cand = d.mi[y4 | 1][b.col - 1]
            step = max(2, min(16, BH4[cand.size]))
            if cand.ref[0] > INTRA_FRAME:
                n += 1
                pw = min(w >> 1, 32 >> sx)
                overlap(cand, b.col, y4, pw, min(h, (step * 4) >> sy),
                        T.OBMC_MASK[pw], 1)
            y4 += step

