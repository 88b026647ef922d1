"""AV1 motion vectors: the reference MV stack (find_mv_stack, spec
7.10.2: the spatial scans, the temporal candidates from the projected
motion field of 7.9, the extra search, compound stacks, contexts and
clamping), the MV syntax, the motion field saved with each frame (7.19),
warp samples (7.10.4) and OBMC neighbours; an `intrabc` block's
displacement (the stack for INTRA_FRAME under MV_INTRABC_CONTEXT), the
variable transform sizes of an inter block (`read_var_tx_size`) and the
intra block copy, a BILINEAR copy from the frame decoded so far
(7.11.3)."""
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
            "bits": [_cdf(b) for b in T.MV_BIT],
            "class0_fr": [_cdf(f) for f in T.MV_CLASS0_FP],
            "fr": _cdf(T.MV_FP), "class0_hp": _cdf(T.MV_CLASS0_HP),
            "hp": _cdf(T.MV_HP)}
    ctx = {"joint": _cdf(T.MV_JOINT), "comp": [copy.deepcopy(comp),
                                               copy.deepcopy(comp)]}
    return {"MV": [copy.deepcopy(ctx), copy.deepcopy(ctx)],
            "TXFM_SPLIT": [_cdf(c) for c in T.TXFM_SPLIT]}


# ---- the reference MV stack (find_mv_stack, 7.10.2) -------------------------
def _round2s(v, n):
    """Round2Signed."""
    return (v + (1 << (n - 1))) >> n if v >= 0 else \
        -((-v + (1 << (n - 1))) >> n)


def lower_precision(d, mv):
    """lower_mv_precision (7.10.2.10)."""
    if d.allow_hp:
        return mv
    out = []
    for v in mv:
        if d.force_imv:
            a = (abs(v) + 3) >> 3
            v = a << 3 if v > 0 else -(a << 3)
        elif v & 1:
            v += -1 if v > 0 else 1
        out.append(v)
    return (out[0], out[1])


def global_mv(d, b, ref):
    """setup_global_mv (7.10.2.1) of reference `ref` for block b."""
    from .av1 import BH4, BW4, INTRA_FRAME, TRANSLATION
    if ref <= INTRA_FRAME or d.gm_type[ref] == 0:
        return (0, 0)
    g = d.gm[ref]
    if d.gm_type[ref] == TRANSLATION:
        # mv[0] from gm_params[0], as the specification (and libaom) has it
        mv = (g[0] >> 13, g[1] >> 13)
    else:
        x = b.col * 4 + BW4[b.size] * 2 - 1
        y = b.row * 4 + BH4[b.size] * 2 - 1
        xc = (g[2] - (1 << 16)) * x + g[3] * y + g[0]
        yc = g[4] * x + (g[5] - (1 << 16)) * y + g[1]
        if d.allow_hp:
            mv = (_round2s(yc, 13), _round2s(xc, 13))
        else:
            mv = (_round2s(yc, 14) * 2, _round2s(xc, 14) * 2)
    return lower_precision(d, mv)


class MvStack:
    """RefStackMv (each entry [mv of list 0, mv of list 1]),
    WeightStack, NumMvFound and the contexts find_mv_stack leaves."""

    def __init__(self):
        self.stack, self.weights = [], []
        self.new_count = 0
        self.found = 0
        self.zero_mv_ctx = 0

    @property
    def count(self):
        return len(self.stack)

    def add(self, mvs, weight):
        for i, m in enumerate(self.stack):
            if m == mvs:
                self.weights[i] += weight
                return
        if len(self.stack) < 8:
            self.stack.append(mvs)
            self.weights.append(weight)

    def drl_ctx(self, i):
        w0, w1 = self.weights[i], self.weights[i + 1]
        if w0 >= REF_CAT_LEVEL:
            return 0 if w1 >= REF_CAT_LEVEL else 1
        return 2 if w1 < REF_CAT_LEVEL else 0


def _candidate(td, st, b, comp, r, c, weight):
    """add_ref_mv_candidate (7.10.2.7)."""
    from .av1 import (BH4, BW4, GLOBAL_GLOBALMV, GLOBALMV, HAS_NEWMV,
                      TRANSLATION)
    cand = td.d.mi[r][c]
    if cand is None or not cand.is_inter:
        return
    d = td.d
    large = min(BW4[cand.size], BH4[cand.size]) >= 2
    gmode = cand.y_mode in (GLOBALMV, GLOBAL_GLOBALMV) and large
    if not comp:
        for lst in range(2):
            if cand.ref[lst] != b.ref[0]:
                continue
            if gmode and d.gm_type[b.ref[0]] > TRANSLATION:
                mv = st.global_mvs[0]
            else:
                mv = lower_precision(d, cand.mv[lst])
            if cand.y_mode in HAS_NEWMV:
                st.new_count += 1
            st.found = 1
            st.add([mv, (0, 0)], weight)
    elif cand.ref == b.ref:
        mvs = [st.global_mvs[i] if gmode and d.gm_type[b.ref[i]] >
               TRANSLATION else lower_precision(d, cand.mv[i])
               for i in range(2)]
        st.found = 1
        st.add(mvs, weight)
        if cand.y_mode in HAS_NEWMV:
            st.new_count += 1


def _scan_row(td, st, b, comp, delta_row):
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
        _candidate(td, st, b, comp, r, c, ln * 2)
        i += ln


def _scan_col(td, st, b, comp, delta_col):
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
        _candidate(td, st, b, comp, r, c, ln * 2)
        i += ln


def _scan_point(td, st, b, comp, dr, dc):
    r, c = b.row + dr, b.col + dc
    if td.inside(r, c) and td.d.mi[r][c] is not None:
        _candidate(td, st, b, comp, r, c, 4)


def _sort(st, start, end):
    w, m = st.weights, st.stack
    while end > start:
        new_end = start
        for i in range(start + 1, end):
            if w[i - 1] < w[i]:
                w[i - 1], w[i] = w[i], w[i - 1]
                m[i - 1], m[i] = m[i], m[i - 1]
                new_end = i
        end = new_end


def _temporal(td, st, b, comp):
    """temporal_scan (7.10.2.5) over the projected motion field."""
    from .av1 import BH4, BW4
    bw4, bh4 = BW4[b.size], BH4[b.size]
    sw, sh = (4 if bw4 >= 16 else 2), (4 if bh4 >= 16 else 2)
    for dr in range(0, min(bh4, 16), sh):
        for dc in range(0, min(bw4, 16), sw):
            _tpl(td, st, b, comp, dr, dc)
    if 2 <= bh4 < 16 and 2 <= bw4 < 16:
        for dr, dc in ((bh4, -2), (bh4, bw4), (bh4 - 2, bw4)):
            r, c = (b.row & 15) + dr, (b.col & 15) + dc
            if 0 <= r < 16 and 0 <= c < 16:
                _tpl(td, st, b, comp, dr, dc)


def _tpl(td, st, b, comp, dr, dc):
    """add_tpl_ref_mv (7.10.2.6): the saved vector at this 8 x 8,
    projected to the block's reference(s)."""
    d = td.d
    r, c = (b.row + dr) | 1, (b.col + dc) | 1
    first = dr == 0 and dc == 0
    if first:
        st.zero_mv_ctx = 1
    if not td.inside(r, c):
        return
    mf = d.motion_field
    y8, x8 = r >> 1, c >> 1
    if not mf["valid"][y8, x8]:
        return
    src = (int(mf["mv"][y8, x8, 0]), int(mf["mv"][y8, x8, 1]))
    off = int(mf["offset"][y8, x8])
    mvs = []
    for i in range(1 + comp):
        dist = d.rel_dist(d.order_hint, d.order_hints[b.ref[i]])
        mvs.append(lower_precision(d, mv_projection(src, dist, off)))
    if first:
        st.zero_mv_ctx = int(any(
            abs(mvs[i][k] - st.global_mvs[i][k]) >= 16
            for i in range(1 + comp) for k in range(2)))
    if not comp:
        mvs.append((0, 0))
    st.add(mvs, 2)


def _extra_search(td, st, b, comp):
    """extra_search (7.10.2.12) and, for a compound block, the stack
    filled from RefIdMvs, RefDiffMvs and the global vectors."""
    from .av1 import BH4, BW4, INTRA_FRAME
    d = td.d
    w4 = min(16, BW4[b.size], d.mi_cols - b.col)
    h4 = min(16, BH4[b.size], d.mi_rows - b.row)
    n = min(w4, h4)
    ids, diffs = [[], []], [[], []]
    for pas in range(2):
        idx = 0
        while idx < n and st.count < 2:
            r, c = (b.row - 1, b.col + idx) if pas == 0 else \
                (b.row + idx, b.col - 1)
            if not td.inside(r, c):
                break
            cand = d.mi[r][c]
            for cl in range(2):
                cr = cand.ref[cl]
                if cr <= INTRA_FRAME:
                    continue
                mv = cand.mv[cl]
                if comp:
                    for lst in range(2):
                        if cr == b.ref[lst] and len(ids[lst]) < 2:
                            ids[lst].append(mv)
                        elif len(diffs[lst]) < 2:
                            if d.sign_bias[cr] != d.sign_bias[b.ref[lst]]:
                                diffs[lst].append((-mv[0], -mv[1]))
                            else:
                                diffs[lst].append(mv)
                else:
                    if d.sign_bias[cr] != d.sign_bias[b.ref[0]]:
                        mv = (-mv[0], -mv[1])
                    if all(m[0] != mv for m in st.stack):
                        st.stack.append([mv, (0, 0)])
                        st.weights.append(2)
            idx += BW4[cand.size] if pas == 0 else BH4[cand.size]
    if comp:
        combined = [[None, None], [None, None]]
        for lst in range(2):
            vals = (ids[lst] + diffs[lst])[:2]
            while len(vals) < 2:
                vals.append(st.global_mvs[lst])
            combined[0][lst], combined[1][lst] = vals
        if st.count == 1:
            pick = combined[1] if combined[0] == st.stack[0] else \
                combined[0]
            st.stack.append(list(pick))
            st.weights.append(2)
        else:
            for k in range(2):
                st.stack.append(list(combined[k]))
                st.weights.append(2)


def find_mv_stack(td, b, comp):
    """find_mv_stack (7.10.2) for block b and its references b.ref: an
    MvStack with NewMvContext, RefMvContext and ZeroMvContext."""
    from .av1 import BH4, BW4
    d = td.d
    bw4, bh4 = BW4[b.size], BH4[b.size]
    st = MvStack()
    st.global_mvs = [global_mv(d, b, b.ref[0]),
                     global_mv(d, b, b.ref[1]) if comp else (0, 0)]
    _scan_row(td, st, b, comp, -1)
    above = st.found
    st.found = 0
    _scan_col(td, st, b, comp, -1)
    left = st.found
    st.found = 0
    if max(bw4, bh4) <= 16:
        _scan_point(td, st, b, comp, -1, bw4)
    above |= st.found
    close = above + left
    n_nearest = st.count
    num_new = st.new_count
    for i in range(n_nearest):
        st.weights[i] += REF_CAT_LEVEL
    st.zero_mv_ctx = 0
    if d.use_ref_frame_mvs:
        _temporal(td, st, b, comp)
    st.found = 0
    _scan_point(td, st, b, comp, -1, -1)
    above |= st.found
    st.found = 0
    _scan_row(td, st, b, comp, -3)
    above |= st.found
    st.found = 0
    _scan_col(td, st, b, comp, -3)
    left |= st.found
    st.found = 0
    if bh4 > 1:
        _scan_row(td, st, b, comp, -5)
    above |= st.found
    st.found = 0
    if bw4 > 1:
        _scan_col(td, st, b, comp, -5)
    left |= st.found
    total = above + left
    _sort(st, 0, n_nearest)
    _sort(st, n_nearest, st.count)
    if st.count < 2:
        _extra_search(td, st, b, comp)
    # context_and_clamping (7.10.2.14)
    top = -(b.row * 4 * 8)
    bottom = (d.mi_rows - bh4 - b.row) * 4 * 8
    lft = -(b.col * 4 * 8)
    rgt = (d.mi_cols - bw4 - b.col) * 4 * 8
    br_, bc_ = MV_BORDER + bh4 * 4 * 8, MV_BORDER + bw4 * 4 * 8
    for e in st.stack:
        for lst in range(1 + comp):
            mv = e[lst]
            e[lst] = (min(max(mv[0], top - br_), bottom + br_),
                      min(max(mv[1], lft - bc_), rgt + bc_))
    st.num = st.count                   # NumMvFound
    while len(st.stack) < 2:            # RefStackMv past it: the global
        st.stack.append([st.global_mvs[0], (0, 0)])
        st.weights.append(0)
    if close == 0:
        st.new_mv_ctx, st.ref_mv_ctx = min(total, 1), total
    elif close == 1:
        st.new_mv_ctx, st.ref_mv_ctx = 3 - min(num_new, 1), 2 + total
    else:
        st.new_mv_ctx, st.ref_mv_ctx = 5 - min(num_new, 1), 5
    return st


def mv_projection(mv, num, den):
    """get_mv_projection: mv scaled by num / den (7.9.3)."""
    den = min(den, 31)
    num = min(num, 31) if num > 0 else max(num, -31)
    f = T.DIV_MULT[den]
    return tuple(max(-(1 << 14) + 1, min((1 << 14) - 1,
                                         _round2s(v * num * f, 14)))
                 for v in mv)


# ---- the motion field (7.9, 7.19) -------------------------------------------
REFMVS_LIMIT = (1 << 12) - 1


def motion_field_store(d):
    """MfRefFrames and MfMvs of the frame (7.19), one per 8 x 8 from its
    bottom-right 4 x 4: a vector to a past reference frame, within
    REFMVS_LIMIT, the later list's where both qualify."""
    rows8, cols8 = d.mi_rows >> 1, d.mi_cols >> 1
    refs = np.zeros((rows8, cols8), np.int8)
    mvs = np.zeros((rows8, cols8, 2), np.int32)
    if d.frame_is_intra:
        return refs, mvs
    for y in range(rows8):
        row = d.mi[2 * y + 1]
        for x in range(cols8):
            b = row[2 * x + 1]
            for lst in range(2):
                rf = b.ref[lst]
                if rf > 0 and d.rel_dist(d.order_hints[rf],
                                         d.order_hint) < 0:
                    mv = b.mv[lst]
                    if abs(mv[0]) <= REFMVS_LIMIT and \
                            abs(mv[1]) <= REFMVS_LIMIT:
                        refs[y, x] = rf
                        mvs[y, x] = mv
    return refs, mvs


def motion_field_estimation(d):
    """The projected motion field (7.9) as libaom keeps it: per 8 x 8 the
    source vector and its frame distance, projected to a block's
    reference when read (add_tpl_ref_mv)."""
    from .av1 import (ALTREF2_FRAME, ALTREF_FRAME, BWDREF_FRAME,
                      GOLDEN_FRAME, LAST2_FRAME, LAST_FRAME)
    rows8, cols8 = d.mi_rows >> 1, d.mi_cols >> 1
    mf = {"valid": np.zeros((rows8, cols8), bool),
          "mv": np.zeros((rows8, cols8, 2), np.int32),
          "offset": np.zeros((rows8, cols8), np.int32)}
    cur = d.order_hint

    def project(src, backward):
        s = d.saved[d.ref_idx[src - 1]]
        if s is None or "mf_refs" not in s or s["frame_type"] in (0, 2) \
                or s["mi_rows"] != d.mi_rows or s["mi_cols"] != d.mi_cols:
            return False
        start = s["order_hint"]
        to_cur = d.rel_dist(start, cur)
        if backward:
            to_cur = -to_cur
        offs = [0] + [d.rel_dist(start, h) for h in s["order_hints"][1:]]
        refs, mvs = s["mf_refs"], s["mf_mvs"]
        for y, x in zip(*np.nonzero(refs > 0)):
            off = offs[refs[y, x]]
            if not (0 < off <= 31 and abs(to_cur) <= 31):
                continue
            mv = (int(mvs[y, x, 0]), int(mvs[y, x, 1]))
            p = mv_projection(mv, to_cur, off)
            ro = p[0] >> 6 if p[0] >= 0 else -((-p[0]) >> 6)
            co = p[1] >> 6 if p[1] >= 0 else -((-p[1]) >> 6)
            r = y - ro if backward else y + ro
            c = x - co if backward else x + co
            by, bx = (y >> 3) << 3, (x >> 3) << 3
            if not (0 <= r < rows8 and 0 <= c < cols8 and by <= r < by + 8
                    and bx - 8 <= c < bx + 16):
                continue
            mf["valid"][r, c] = True
            mf["mv"][r, c] = mv
            mf["offset"][r, c] = off
        return True
    hint = d.order_hints
    stamp = 2
    last = d.saved[d.ref_idx[0]]
    if last is not None and "order_hints" in last:
        if last["order_hints"][ALTREF_FRAME] != hint[GOLDEN_FRAME]:
            project(LAST_FRAME, True)
        stamp -= 1
    if d.rel_dist(hint[BWDREF_FRAME], cur) > 0 and \
            project(BWDREF_FRAME, False):
        stamp -= 1
    if d.rel_dist(hint[ALTREF2_FRAME], cur) > 0 and \
            project(ALTREF2_FRAME, False):
        stamp -= 1
    if d.rel_dist(hint[ALTREF_FRAME], cur) > 0 and stamp >= 0 and \
            project(ALTREF_FRAME, False):
        stamp -= 1
    if stamp >= 0:
        project(LAST2_FRAME, True)
    return mf


# ---- warp samples and OBMC neighbours (7.10.4, 7.11.3.10) ------------------
def has_overlappable_candidates(td, b):
    from .av1 import BH4, BW4, INTRA_FRAME
    d = td.d
    if b.avail[0]:
        for x4 in range(b.col, min(d.mi_cols, b.col + BW4[b.size]), 2):
            x5 = min(x4 | 1, d.mi_cols - 1)
            if d.mi[b.row - 1][x5].ref[0] > INTRA_FRAME:
                return True
    if b.avail[1]:
        for y4 in range(b.row, min(d.mi_rows, b.row + BH4[b.size]), 2):
            y5 = min(y4 | 1, d.mi_rows - 1)
            if d.mi[y5][b.col - 1].ref[0] > INTRA_FRAME:
                return True
    return False


def find_warp_samples(td, b):
    """find_warp_samples (7.10.4): CandList of the neighbours that share
    the block's reference, those whose vectors differ by more than the
    threshold dropped but the first; [] where none was scanned."""
    from .av1 import BH4, BW4, NONE_FRAME
    d = td.d
    w4, h4 = BW4[b.size], BH4[b.size]
    cands = [None] * 8
    num, scanned = [0], [0]
    thresh = min(max(max(w4, h4) * 4, 16), 112)

    def add(dr, dc):
        if scanned[0] >= 8:
            return
        r, c = b.row + dr, b.col + dc
        if not td.inside(r, c) or d.mi[r][c] is None:
            return
        cand = d.mi[r][c]
        if cand.ref[0] != b.ref[0] or cand.ref[1] != NONE_FRAME:
            return
        cw, ch = BW4[cand.size], BH4[cand.size]
        cr, cc = r & ~(ch - 1), c & ~(cw - 1)
        my, mx = cr * 4 + ch * 2 - 1, cc * 4 + cw * 2 - 1
        mv = cand.mv[0]
        valid = abs(mv[0] - b.mv[0][0]) + abs(mv[1] - b.mv[0][1]) <= thresh
        scanned[0] += 1
        if not valid and scanned[0] > 1:
            return
        cands[num[0]] = (my * 8, mx * 8, my * 8 + mv[0], mx * 8 + mv[1])
        if valid:
            num[0] += 1
    top_left = top_right = True
    if b.avail[0]:
        sw = BW4[d.mi[b.row - 1][b.col].size]
        if w4 <= sw:
            off = -(b.col & (sw - 1))
            if off < 0:
                top_left = False
            if off + sw > w4:
                top_right = False
            add(-1, 0)
        else:
            i = 0
            while i < min(w4, d.mi_cols - b.col):
                step = max(BW4[d.mi[b.row - 1][b.col + i].size], 1)
                add(-1, i)
                i += step
    if b.avail[1]:
        sh = BH4[d.mi[b.row][b.col - 1].size]
        if h4 <= sh:
            if -(b.row & (sh - 1)) < 0:
                top_left = False
            add(0, -1)
        else:
            i = 0
            while i < min(h4, d.mi_rows - b.row):
                step = max(BH4[d.mi[b.row + i][b.col - 1].size], 1)
                add(i, -1)
                i += step
    if top_left:
        add(-1, -1)
    if top_right and max(w4, h4) <= 16:
        add(-1, w4)
    n = num[0] if num[0] or not scanned[0] else 1
    return cands[:n]


def is_scaled(d, ref):
    """Whether reference `ref` differs in size from the frame (7.11.3.3's
    scale factors other than 1 << REF_SCALE_SHIFT)."""
    s = d.saved[d.ref_idx[ref - 1]]
    xs = ((s["up_w"] << 14) + d.w // 2) // d.w
    ys = ((s["h"] << 14) + d.h // 2) // d.h
    return xs != 1 << 14 or ys != 1 << 14


def read_mv(td, ctx):
    """read_mv (5.11.32): the coded difference (row, col) under MvCtx
    `ctx`, at the frame's precision."""
    sd, d = td.sd, td.d
    c = td.cdf["MV"][ctx]
    joint = sd.symbol(c["joint"])

    def comp(cd):
        sign = sd.symbol(cd["sign"])
        cls = sd.symbol(cd["class"])
        if cls == 0:
            b0 = sd.symbol(cd["class0"])
            fr = 3 if d.force_imv else sd.symbol(cd["class0_fr"][b0])
            hp = sd.symbol(cd["class0_hp"]) if d.allow_hp else 1
            mag = ((b0 << 3) | (fr << 1) | hp) + 1
        else:
            dd = 0
            for i in range(cls):
                dd |= sd.symbol(cd["bits"][i]) << i
            fr = 3 if d.force_imv else sd.symbol(cd["fr"])
            hp = sd.symbol(cd["hp"]) if d.allow_hp else 1
            mag = (2 << (cls + 2)) + ((dd << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag
    dr = comp(c["comp"][0]) if joint in (2, 3) else 0
    dc = comp(c["comp"][1]) if joint in (1, 3) else 0
    return dr, dc


def intrabc_mv(td, b, r, c):
    """The block's displacement (row, col) in 1/8 pixel units."""
    from .av1 import BH4
    st = find_mv_stack(td, b, 0)
    pred = st.stack[0][0]
    if pred == (0, 0):
        pred = st.stack[1][0]
    if pred == (0, 0):
        sb4 = BH4[15] if td.sb4 == 32 else BH4[12]
        if r - sb4 < td.r0:
            pred = (0, -(sb4 * 4 + INTRABC_DELAY_PIXELS) * 8)
        else:
            pred = (-(sb4 * 4 * 8), 0)
    pred = ((pred[0] >> 3) * 8, (pred[1] >> 3) * 8)
    dr, dc = read_mv(td, 1)
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
    mv = b.mv[0]
    px = (x << 4) + ((2 * mv[1]) >> sx)
    py = (y << 4) + ((2 * mv[0]) >> sy)
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
