"""JPEG 2000 tier-1 in numpy: the MQ arithmetic coder and EBCOT's three
coding passes (ITU-T T.800 Annexes C and D), decoded as OpenJPEG decodes
them and encoded for the port's .jp2 writer.

A code-block is an independent arithmetic-coded stream, and a Python
loop per decision is far too slow for a whole tile, so every code-block
of a tile is a lane and all lanes step together: one vectorised MQ
decision a step (`_MQDecoder` / `mq_encode`, one state a lane; a lane
without a decision codes in an idle state that changes nothing). Passes
go in lockstep: every lane runs its k-th pass (clean-up, significance
propagation, magnitude refinement, clean-up, ...) together, each lane
from its own most significant plane. A step costs tens of microseconds
however few lanes it serves, so when at most TAIL lanes are left in a
pass, each finishes it alone in Python integers (`_ScalarDec`,
`_tail_sp`, `_tail_cu`), a few microseconds a decision.

Each lane's coefficients lie in stripe-scan order (stripes of four rows,
a stripe column by column), so the window after a position is a run of
one row of an array. A coefficient's flags word holds the significance
of its eight neighbours, the signs of the four direct ones, and its own
refined, significant and visited bits; one lookup of (mode, orientation,
flags) gives the context. Values keep OpenJPEG's doubled scale: a
coefficient that becomes significant at plane p holds 3 << p, and each
refinement moves it by 1 << p, so a truncated coefficient sits at the
middle of its interval (`CodeBlocks.values` / 2 truncated is the
reversible coefficient; times half the step size, the irreversible one).

A code-block's passes come in codeword segments (T.800 D.4, as
OpenJPEG's tier-2 cuts them): the MQ decoder starts anew at each
segment, its contexts kept. The decoder takes every Part 1 code-block
style (T.800 Table A.19), as OpenJPEG's opj_t1_decode_cblk does:
selective arithmetic coding bypass (the significance and refinement
passes of a raw segment read bits with OpenJPEG's raw decoder, sign bits
unpredicted), context reset after each MQ pass, termination on each
pass (one pass a segment), the vertically causal context (a stripe's
last row sees nothing of the stripe below), predictable termination
(OpenJPEG only checks it), and the segmentation symbol (four uniform
decisions after each clean-up pass). An RGN shift s (maxshift) decodes
s more bit-planes and then divides by 2^s every coefficient of at least
2^s in the doubled scale, as OpenJPEG does; whether a segment is raw is
still decided from the planes without s, as OpenJPEG decides it. The
encoder writes style 0 only.
"""
from __future__ import annotations

import numpy as np

# the 47-state probability estimation table (T.800 Table C.2):
# (Qe, NMPS, NLPS, SWITCH)
_QE_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))

# a context's state is 2 * index + MPS; per state: Qe, and the state
# after an MPS or an LPS renormalisation. State 94 (Qe 0) is the idle
# state of a lane that makes no decision in a step: coding in it changes
# nothing.
QE = np.array([q for q, _, _, _ in _QE_TABLE for _ in (0, 1)] + [0],
              np.int64)
NEXT_MPS = np.array([2 * n + m for _, n, _, _ in _QE_TABLE for m in (0, 1)]
                    + [94], np.int64)
NEXT_LPS = np.array([2 * n + (m ^ s) for _, _, n, s in _QE_TABLE
                     for m in (0, 1)] + [94], np.int64)
# shifts that bring A (below 0x8000) back to 0x8000 or more
_SHIFTS = np.zeros(1 << 16, np.int64)
_SHIFTS[1:0x8000] = 15 - np.floor(np.log2(np.arange(1, 0x8000))).astype(
    np.int64)

# the state after a decision, by 4 * state + 2 * (LPS symbol) +
# (renormalised)
_NEXT = np.stack([np.arange(95), NEXT_MPS, np.arange(95), NEXT_LPS],
                 1).ravel()

N_CTX = 19
CTX_RL, CTX_UNI, CTX_IDLE = 17, 18, 19
# T.800 Table D.7: UNIFORM 46, run-length 3, zero-coding context 0 at 4
INITIAL_STATES = np.zeros(N_CTX + 1, np.int64)
INITIAL_STATES[[0, CTX_RL, CTX_UNI, CTX_IDLE]] = (2 * 4, 2 * 3, 2 * 46, 94)
SLOTS = N_CTX + 1


class _MQDecoder:
    """MQ decoders of many lanes (T.800 C.3, OpenJPEG's opj_mqc_decode),
    every codeword segment of every lane in one flat byte array, each
    followed by 0xFF 0xFF as OpenJPEG appends them, so a decoder that runs
    past its data reads 1 bits. streams: per lane the list of its
    segments' bytes; each lane starts at its first. `offsets[i][j]` is
    where lane i's segment j starts."""

    def __init__(self, streams):
        self.offsets, chunks, pos = [], [], 0
        for segs in streams:
            offs = []
            for seg in segs or [b""]:
                offs.append(pos)
                chunks.append(bytes(seg) + b"\xff\xff")
                pos += len(seg) + 2
            self.offsets.append(offs)
        self.raw = b"".join(chunks) + b"\xff\xff"
        self.data = np.frombuffer(self.raw, np.uint8).astype(np.int64)
        n = len(streams)
        self.bp = np.zeros(n, np.int64)
        self.C = np.zeros(n, np.int64)
        self.CT = np.zeros(n, np.int64)
        self.A = np.full(n, 0x8000, np.int64)
        self.states = np.tile(INITIAL_STATES, (n, 1))
        self.start(np.arange(n), np.array([o[0] for o in self.offsets],
                                          np.int64), np.zeros(n, bool))

    def start(self, j, at, raw):
        """Lanes j begin a segment at byte `at`: the raw decoder
        (opj_mqc_raw_init_dec: C and CT 0) where `raw`, else INITDEC
        (T.800 C.3.5); the contexts stay."""
        self.bp[j] = at
        r, m = j[raw], j[~raw]
        self.C[r] = self.CT[r] = 0
        if len(m):
            self.C[m] = self.data[self.bp[m]] << 16
            self.CT[m] = 0
            _bytein(self, m)
            self.C[m] <<= 7
            self.CT[m] -= 7
            self.A[m] = 0x8000

    def lanes(self, idx):
        return _DecLanes(self, idx)

    def raw_lanes(self, idx):
        return _RawLanes(self, idx)


def _bytein(r, j):
    """BYTEIN of lanes j of registers r (T.800 C.3.4): after 0xFF a byte
    above 0x8F is a marker, which feeds 1 bits and is not passed."""
    bp = r.bp[j]
    b = r.data[bp]
    b1 = r.data[bp + 1]
    ff = b == 0xFF
    stay = ff & (b1 > 0x8F)
    r.C[j] += np.where(ff, np.where(stay, 0xFF00, b1 << 9), b1 << 8)
    r.CT[j] = np.where(ff & ~stay, 7, 8)
    r.bp[j] = bp + ~stay


class _DecLanes:
    """The registers of the lanes of one pass, decoded together and
    written back by `close`."""
    is_raw = False

    def __init__(self, mq: _MQDecoder, idx):
        self.mq, self.idx = mq, idx
        self.A, self.C = mq.A[idx], mq.C[idx]
        self.CT, self.bp = mq.CT[idx], mq.bp[idx]
        self.st = mq.states[idx].ravel()
        self.base = np.arange(len(idx), dtype=np.int64) * SLOTS
        self.idle = self.base + CTX_IDLE
        self.data = mq.data

    def close(self):
        mq, idx = self.mq, self.idx
        mq.A[idx], mq.C[idx], mq.CT[idx], mq.bp[idx] = (self.A, self.C,
                                                        self.CT, self.bp)
        mq.states[idx] = self.st.reshape(len(idx), SLOTS)

    def code(self, ctx, on, want=None):
        """One decision of each lane where `on`, in context ctx: the
        decoded symbols (0 where not on)."""
        si = np.where(on, self.base + ctx, self.idle)
        s = self.st[si]
        q = QE[s]
        A = self.A - q
        C = self.C
        q16 = q << 16
        lps = C < q16
        a_lt = A < q
        # an exchange: the LPS path gives the LPS unless A < Qe, the MPS
        # path (when it renormalises) gives it when A < Qe
        lps_sym = lps ^ a_lt
        renorm = lps | (A < 0x8000)
        self.C = np.where(lps, C, C - q16)
        A = np.where(lps, q, A)
        self.st[si] = _NEXT[(s << 2) | (lps_sym << 1) | renorm]
        n = _SHIFTS[A]
        CT = self.CT
        big = n > CT
        if np.count_nonzero(big):
            self._slow(big.nonzero()[0], A, n)
        self.A = A << n
        self.C <<= n
        self.CT = CT - n
        return (s & 1) ^ lps_sym

    def _slow(self, j, A, n):
        """RENORMD of lanes j that pass a byte boundary: shift to the
        boundary and BYTEIN (again while the shift left passes the next
        one); the caller shifts by the n left."""
        while len(j):
            k = self.CT[j]
            A[j] <<= k
            self.C[j] <<= k
            n[j] -= k
            _bytein(self, j)
            j = j[n[j] > self.CT[j]]

    def scalar(self, i):
        return _ScalarDec(self, i)


_QE_L, _NMPS_L, _NLPS_L = QE.tolist(), NEXT_MPS.tolist(), NEXT_LPS.tolist()


class _ScalarDec:
    """Lane i's MQ decoder in Python integers, for the last few lanes of
    a pass: a decision costs microseconds here against a lockstep step's
    tens for any number of lanes. `close` writes the registers back."""
    is_raw = False

    def __init__(self, lanes: _DecLanes, i):
        self.lanes, self.i = lanes, i
        self.A, self.C = int(lanes.A[i]), int(lanes.C[i])
        self.CT, self.bp = int(lanes.CT[i]), int(lanes.bp[i])
        self.st = lanes.st[i * SLOTS:(i + 1) * SLOTS].tolist()
        self.raw = lanes.mq.raw

    def code(self, cx, want=None):
        st = self.st
        s = st[cx]
        q = _QE_L[s]
        A = self.A - q
        C = self.C
        if C < q << 16:                    # the LPS path: an exchange
            if A < q:
                d, st[cx] = s & 1, _NMPS_L[s]
            else:
                d, st[cx] = 1 - (s & 1), _NLPS_L[s]
            A = q
        else:
            C -= q << 16
            if A & 0x8000:
                self.A, self.C = A, C
                return s & 1
            if A < q:
                d, st[cx] = 1 - (s & 1), _NLPS_L[s]
            else:
                d, st[cx] = s & 1, _NMPS_L[s]
        CT = self.CT
        while True:
            if CT == 0:                    # BYTEIN
                raw, bp = self.raw, self.bp
                b1 = raw[bp + 1]
                if raw[bp] != 0xFF:
                    self.bp, C, CT = bp + 1, C + (b1 << 8), 8
                elif b1 > 0x8F:
                    C, CT = C + 0xFF00, 8
                else:
                    self.bp, C, CT = bp + 1, C + (b1 << 9), 7
            A <<= 1
            C <<= 1
            CT -= 1
            if A & 0x8000:
                break
        self.A, self.C, self.CT = A, C, CT
        return d

    def close(self):
        lanes, i = self.lanes, self.i
        lanes.A[i], lanes.C[i], lanes.CT[i], lanes.bp[i] = (
            self.A, self.C, self.CT, self.bp)
        lanes.st[i * SLOTS:(i + 1) * SLOTS] = self.st


class _RawLanes:
    """The raw (bypass) decoders of the lanes of one pass (OpenJPEG's
    opj_mqc_raw_decode): C holds the last byte, CT its bits left; after
    0xFF the next byte gives 7 bits, or, above 0x8F (a marker, or the
    0xFF 0xFF after the segment), is not passed and 0xFF is read again.
    The context is ignored."""
    is_raw = True

    def __init__(self, mq: _MQDecoder, idx):
        self.mq, self.idx = mq, idx
        self.C, self.CT, self.bp = mq.C[idx], mq.CT[idx], mq.bp[idx]
        self.data = mq.data

    def close(self):
        mq, idx = self.mq, self.idx
        mq.C[idx], mq.CT[idx], mq.bp[idx] = self.C, self.CT, self.bp

    def code(self, ctx, on, want=None):
        j = (on & (self.CT == 0)).nonzero()[0]
        if len(j):
            bp = self.bp[j]
            b = self.data[bp]
            ff = self.C[j] == 0xFF
            stay = ff & (b > 0x8F)
            self.C[j] = np.where(stay, 0xFF, b)
            self.CT[j] = np.where(ff & ~stay, 7, 8)
            self.bp[j] = bp + ~stay
        self.CT = self.CT - on
        return np.where(on, (self.C >> self.CT) & 1, 0)

    def scalar(self, i):
        return _ScalarRaw(self, i)


class _ScalarRaw:
    """Lane i's raw decoder in Python integers."""
    is_raw = True

    def __init__(self, lanes: _RawLanes, i):
        self.lanes, self.i = lanes, i
        self.C, self.CT = int(lanes.C[i]), int(lanes.CT[i])
        self.bp = int(lanes.bp[i])
        self.buf = lanes.mq.raw

    def code(self, cx, want=None):
        if self.CT == 0:
            b = self.buf[self.bp]
            if self.C == 0xFF and b > 0x8F:
                self.CT = 8
            else:
                self.CT = 7 if self.C == 0xFF else 8
                self.C, self.bp = b, self.bp + 1
        self.CT -= 1
        return (self.C >> self.CT) & 1

    def close(self):
        lanes, i = self.lanes, self.i
        lanes.C[i], lanes.CT[i], lanes.bp[i] = self.C, self.CT, self.bp


def mq_encode(ctx, sym, marks):
    """MQ encoders of many lanes (T.800 C.2, OpenJPEG's
    opj_mqc_encode) over each lane's recorded sequence. ctx, sym:
    [n, T] per lane (ctx -1 past a lane's end); marks: [n, P] symbol
    counts after which the byte count is wanted (-1: none). Returns
    (n terminated byte strings, [n, P] byte counts at the marks, as
    OpenJPEG's opj_mqc_numbytes)."""
    n, T = ctx.shape
    out = np.zeros((n, T // 4 + 64), np.uint8)   # grown as bytes come
    rows = np.arange(n)
    A = np.full(n, 0x8000, np.int64)
    C = np.zeros(n, np.int64)
    CT = np.full(n, 12, np.int64)
    bp = np.zeros(n, np.int64)       # out[:, 0] is the byte before start
    st = np.tile(INITIAL_STATES, (n, 1)).ravel()
    base = rows * SLOTS
    idle = base + CTX_IDLE
    at = np.zeros(marks.shape, np.int64)
    when = {}
    for i, j in zip(*np.nonzero(marks >= 0)):
        when.setdefault(int(marks[i, j]), []).append((i, j))

    def byteout(j):
        nonlocal out
        if bp[j].max() + 2 >= out.shape[1]:
            out = np.concatenate([out, np.zeros_like(out)], 1)
        b = out[j, bp[j]]
        c = C[j]
        carry = (b != 0xFF) & ((c & 0x8000000) != 0)
        b = b + carry
        out[j, bp[j]] = b
        c = np.where(carry, c & 0x7FFFFFF, c)
        ff = b == 0xFF
        out[j, bp[j] + 1] = np.where(ff, c >> 20, c >> 19) & 0xFF
        C[j] = np.where(ff, c & 0xFFFFF, c & 0x7FFFF)
        CT[j] = np.where(ff, 7, 8)
        bp[j] += 1

    for t in range(T + 1):
        for i, j in when.get(t, ()):
            at[i, j] = bp[i] - 1
        if t == T:
            break
        cx = ctx[:, t].astype(np.int64)
        on = cx >= 0
        si = np.where(on, base + cx, idle)
        s = st[si]
        q = QE[s]
        is_mps = np.where(on, sym[:, t], 0) == (s & 1)
        A1 = A - q
        lt = A1 < q
        renorm = ~is_mps | (A1 < 0x8000)
        to_q = np.where(is_mps, lt, ~lt) & renorm
        A = np.where(to_q, q, A1)
        C = np.where(to_q, C, C + q)
        st[si] = np.where(renorm, np.where(is_mps, NEXT_MPS[s],
                                           NEXT_LPS[s]), s)
        nsh = _SHIFTS[A]
        big = nsh >= CT
        if np.count_nonzero(big):
            r = big.nonzero()[0]
            nr = nsh[r]
            nsh[r] = 0
            while len(r):
                k = np.minimum(nr, CT[r])
                A[r] <<= k
                C[r] <<= k
                CT[r] -= k
                nr -= k
                bo = CT[r] == 0
                if np.count_nonzero(bo):
                    byteout(r[bo])
                keep = nr > 0
                r, nr = r[keep], nr[keep]
        A <<= nsh
        C <<= nsh
        CT -= nsh
    # FLUSH: SETBITS, two byte-outs, and no trailing 0xFF
    tempc = C + A
    C |= 0xFFFF
    C = np.where(C >= tempc, C - 0x8000, C)
    for _ in range(2):
        C <<= CT
        byteout(rows)
    bp += out[rows, bp] != 0xFF
    lengths = bp - 1
    streams = [out[i, 1:1 + lengths[i]].tobytes() for i in range(n)]
    return streams, at


# ---------------------------------------------------------------------------
# context modelling
# ---------------------------------------------------------------------------

# a coefficient's flags: neighbour significance (NW N NE W E SW S SE),
# the signs of the N W E S neighbours, refined before, significant,
# visited in this plane's significance pass, and padding
NBR = 0xFF
MU, SIG, PI, PAD = 1 << 12, 1 << 13, 1 << 14, 1 << 15
KEY = 0x1FFF
# neighbour directions (dy, dx) and the bits a newly significant
# coefficient sets in that neighbour's flags: it is the neighbour's
# opposite neighbour, with its sign where that one is N, W, E or S
_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
_SETS = np.array([1 << 7, 1 << 6, 1 << 5, 1 << 4, 1 << 3, 1 << 2, 1 << 1,
                  1 << 0], np.int64)
_SIGNS = np.array([0, 1 << 11, 0, 1 << 10, 1 << 9, 0, 1 << 8, 0], np.int64)

# modes: what a lane's next decision is
M_SIG, M_SIGN, M_REF, M_RL, M_UNI1, M_UNI2, M_DONE = range(7)


def _context_tables():
    """ctx[(mode * 4 + orientation) * 8192 + (flags & KEY)] and the sign
    XOR bit xor[flags & KEY] (T.800 Tables D.1-D.4; orientation 0 LL,
    1 HL, 2 LH, 3 HH, OpenJPEG's band numbers)."""
    f = np.arange(KEY + 1)
    bit = [(f >> i) & 1 for i in range(13)]
    nw, n, ne, w, e, sw, s, se = bit[:8]
    h, v, d = w + e, n + s, nw + ne + sw + se
    ctx = np.zeros((7, 4, KEY + 1), np.int8)

    def zc(h, v, d):
        return np.select(
            [h == 2, (h == 1) & (v >= 1), (h == 1) & (d >= 1), h == 1,
             v == 2, v == 1, d >= 2, d == 1], [8, 7, 6, 5, 4, 3, 2, 1], 0)
    hv = h + v
    hh = np.select([d >= 3, (d == 2) & (hv >= 1), d == 2,
                    (d == 1) & (hv >= 2), (d == 1) & (hv == 1), d == 1,
                    hv >= 2, hv == 1], [8, 7, 6, 5, 4, 3, 2, 1], 0)
    for o, t in ((0, zc(h, v, d)), (1, zc(v, h, d)), (2, zc(h, v, d)),
                 (3, hh)):
        ctx[M_SIG, o] = t
    # sign: each direction's contribution +1 / -1 (significant, positive
    # / negative), clipped per axis
    sn, sw_, se_, ss = bit[8:12]
    hc = np.clip(w * (1 - 2 * sw_) + e * (1 - 2 * se_), -1, 1)
    vc = np.clip(n * (1 - 2 * sn) + s * (1 - 2 * ss), -1, 1)
    flip = (hc < 0) | ((hc == 0) & (vc < 0))
    hc2, vc2 = np.where(flip, -hc, hc), np.where(flip, -vc, vc)
    sc = np.select([hc2 == 1], [12 + vc2], 9 + np.abs(vc2))
    xor = flip.astype(np.int64)
    mu = bit[12]
    mag = np.where(mu == 1, 16, np.where((f & NBR) != 0, 15, 14))
    for o in range(4):
        ctx[M_SIGN, o] = sc
        ctx[M_REF, o] = mag
        ctx[M_RL, o] = CTX_RL
        ctx[M_UNI1, o] = ctx[M_UNI2, o] = CTX_UNI
    return ctx.ravel().astype(np.int64), xor


CTX_LUT, XOR_LUT = _context_tables()


def _scan_order(h: int, w: int):
    """The stripe scan of an h x w code-block: (rows, cols) of each scan
    position."""
    ys, xs = [], []
    for y0 in range(0, h, 4):
        rows = np.arange(y0, min(y0 + 4, h))
        ys.append(np.tile(rows, w))
        xs.append(np.repeat(np.arange(w), len(rows)))
    if not ys:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ys), np.concatenate(xs)


class _Shapes:
    """Per code-block shape (h, w, vertically causal): scan order, the
    scan positions of each position's eight neighbours that learn of its
    significance (n for none; under the vertically causal context a
    stripe's first row tells the stripe above nothing), and where a
    run-length column starts, each padded to n positions; rows of flat
    tables by shape id * n."""

    def __init__(self, shapes, n):
        self.ids = {}
        nbr, rl, ys, xs = [], [], [], []
        for key in shapes:
            if key in self.ids:
                continue
            self.ids[key] = len(nbr)
            h, w, vsc = key
            y, x = _scan_order(h, w)
            pos = np.full((h + 2, w + 2), n, np.int64)
            pos[y + 1, x + 1] = np.arange(len(y))
            t = np.full((n + 1, 8), n, np.int64)
            for k, (dy, dx) in enumerate(_DIRS):
                t[:len(y), k] = pos[y + 1 + dy, x + 1 + dx]
                if vsc and dy < 0:
                    t[:len(y), k][y % 4 == 0] = n
            r = np.zeros(n + 1, bool)
            r[:len(y)] = ((y // 4) * 4 + 4 <= h) & (y % 4 == 0)
            nbr.append(t)
            rl.append(r)
            ys.append(np.pad(y, (0, n - len(y))))
            xs.append(np.pad(x, (0, n - len(x))))
        self.nbr = np.concatenate(nbr)            # [(n + 1) * shapes, 8]
        self.rl = np.concatenate(rl)
        self.y, self.x = np.stack(ys), np.stack(xs)


WINDOW = 32
# the clean-up pass's transitions by 2 * mode + symbol: the next mode
# (the lanes that advance get theirs from `land`), the advance, and
# whether a uniform symbol is decoded
_NEXT_MODE = np.array([M_SIG, M_SIGN, M_SIGN, M_SIGN, M_REF, M_REF,
                       M_SIG, M_UNI1, M_UNI2, M_UNI2, M_SIGN, M_SIGN,
                       M_DONE, M_DONE])
_ADVANCE = np.array([1, 0, 1, 1, 0, 0, 4, 0, 0, 0, 0, 0, 0, 0])
_UNI = np.array([0] * 8 + [1] * 4 + [0] * 2, bool)
# per flags word: coded by the significance pass (insignificant, not
# visited, a significant neighbour), refined (significant before this
# plane), coded by the clean-up pass, the start of a run-length column
_F = np.arange(1 << 16)
SP_OK = ((_F & (SIG | PI | PAD)) == 0) & ((_F & NBR) != 0)
MR_OK = (_F & (SIG | PI | PAD)) == SIG
CU_OK = (_F & (SIG | PI | PAD)) == 0
QUIET = (_F & (SIG | PI | PAD | NBR)) == 0
del _F
# a pass hands its lanes to Python integers when this few are left
TAIL = 64
_CTX_L, _XOR_L = CTX_LUT.tolist(), XOR_LUT.tolist()
# a raw sign bit is the sign itself
_NO_XOR = np.zeros_like(XOR_LUT)
_NO_XOR_L = _NO_XOR.tolist()
# code-block styles (T.800 Table A.19): those the passes act on, and
# termination on each pass, which tier-2's segments carry (predictable
# termination changes nothing a decoder does)
BYPASS, RESET, TERMALL, VCAUSAL, SEGSYM = 1, 2, 4, 8, 32
_SP_OK_L, _QUIET_L = SP_OK.tolist(), QUIET.tolist()
_SETS_L, _SIGNS_L = _SETS.tolist(), _SIGNS.tolist()


class CodeBlocks:
    """Code-blocks as lanes of one tier-1 run.

    shapes: (h, w) of each block; orient: its band (0 LL, 1 HL, 2 LH,
    3 HH); planes: its number of magnitude bit-planes (OpenJPEG's
    numbps: Mb less the zero bit-planes); passes: the coding passes to
    run; styles: its code-block style bits (decoding only; 0 where
    None); shifts: its component's RGN shift (0 where None). After
    `decode` or `encode`, `block(i)` is block i's coefficients in
    OpenJPEG's doubled scale as an [h, w] array."""

    def __init__(self, shapes, orient, planes, passes, styles=None,
                 shifts=None):
        self.L = len(shapes)
        self.hw = [tuple(int(v) for v in s) for s in shapes]
        self.style = np.zeros(self.L, np.int64) if styles is None else \
            np.asarray(styles, np.int64)
        self.shift = np.zeros(self.L, np.int64) if shifts is None else \
            np.asarray(shifts, np.int64)
        self.sizes = np.array([h * w for h, w in self.hw], np.int64)
        self.N = int(self.sizes.max()) if self.L else 0
        self.R = self.N + 2 * WINDOW
        keys = [(h, w, bool(st & VCAUSAL))
                for (h, w), st in zip(self.hw, self.style)]
        self.shapes = _Shapes(keys, self.N) if self.L else None
        self.shape_id = np.array([self.shapes.ids[k] for k in keys],
                                 np.int64) if self.L else np.zeros(0, int)
        self.orient = np.asarray(orient, np.int64)
        # the planes the passes run over (RGN's shift on top), and the
        # planes that decide a raw segment (without it)
        self.numbps = np.asarray(planes, np.int64)
        self.planes = self.numbps + self.shift
        self.passes = np.minimum(np.asarray(passes, np.int64),
                                 np.maximum(3 * self.planes - 2, 0))
        self.seg_start = self.raw_pass = None
        self.flags = np.full((self.L, self.R), PAD, np.int64)
        self.flags[np.arange(self.R)[None, :] < self.sizes[:, None]] = 0
        self.values = np.zeros((self.L, self.R), np.int64)
        self.F, self.V = self.flags.reshape(-1), self.values.reshape(-1)
        self.mag = None
        self._lists = {}

    # -- entry points ------------------------------------------------------

    def decode(self, segs):
        """Run the passes on each lane's codeword segments: per lane the
        list of its (bytes, passes) segments. A segment is raw (bypass)
        where it starts at a significance or refinement pass at most
        numbps - 4 planes up (opj_t1_decode_cblk). Then RGN's shift is
        undone."""
        if not self.L:
            return self
        mq = _MQDecoder([[d for d, _ in lane] for lane in segs])
        P = max(int(self.passes.max()), 1)
        self.seg_start = np.full((self.L, P), -1, np.int64)
        self.raw_pass = np.zeros((self.L, P), bool)
        for i, lane in enumerate(segs):
            k, top = 0, int(self.passes[i])
            bypass = bool(self.style[i] & BYPASS)
            for j, (_, n) in enumerate(lane):
                if k >= top:
                    break
                raw = bypass and (k + 2) % 3 < 2 and \
                    self.planes[i] - (k + 2) // 3 <= self.numbps[i] - 4
                if j:
                    self.seg_start[i, k] = mq.offsets[i][j]
                self.raw_pass[i, k:k + n] = raw
                k += n
        self._run(mq)
        sh = self.shift[:, None]
        if sh.any():
            V = self.values
            mag = np.abs(V)
            big = (sh > 0) & (mag >= (1 << sh))
            self.values = np.where(big, np.where(V < 0, -(mag >> sh),
                                                 mag >> sh), V)
            self.V = self.values.reshape(-1)
        return self

    def encode(self, coeffs):
        """Code the integer coefficients of each block (a list of [h, w]
        arrays) through every pass. Returns per lane the terminated MQ
        stream and the byte count that decodes each pass (OpenJPEG's
        rule: the bytes so far plus 3, at most the stream's length, not
        ending on 0xFF; the last pass is terminated); `dist[i, k]` is the
        squared coefficient error after block i's first k passes."""
        self.mag = np.zeros((self.L, self.R), np.int64)
        self.neg = np.zeros((self.L, self.R), bool)
        for i, c in enumerate(coeffs):
            sid, n = self.shape_id[i], self.sizes[i]
            c = np.asarray(c, np.int64)[self.shapes.y[sid, :n],
                                        self.shapes.x[sid, :n]]
            self.mag[i, :n] = np.abs(c)
            self.neg[i, :n] = c < 0
        P = int(self.passes.max()) if self.L else 0
        self.dist = np.zeros((self.L, P + 1))
        self.dist[:, 0] = (self.mag.astype(np.float64) ** 2).sum(1)
        rec = _Recorder(self.L)
        self._run(rec)
        ctx, sym, ends = rec.sequences()
        marks = np.full((self.L, max(P, 1)), -1, np.int64)
        for i, e in enumerate(ends):
            marks[i, :len(e)] = e
        streams, at = mq_encode(ctx, sym, marks)
        rates = []
        for i, s in enumerate(streams):
            r = np.minimum(at[i, :self.passes[i]] + 3, len(s))
            if len(r):
                r[-1] = len(s)
                buf = np.frombuffer(s, np.uint8)
                r = np.where((r > 1) & (buf[np.maximum(r - 1, 0)] == 0xFF),
                             r - 1, r)
            rates.append(r.astype(np.int64))
        return streams, rates

    def block(self, i):
        h, w = self.hw[i]
        sid, n = self.shape_id[i], self.sizes[i]
        out = np.zeros((h, w), np.int64)
        out[self.shapes.y[sid, :n], self.shapes.x[sid, :n]] = \
            self.values[i, :n]
        return out

    # -- the passes --------------------------------------------------------

    def _run(self, coder):
        P = int(self.passes.max()) if self.L else 0
        for k in range(P):
            idx = (self.passes > k).nonzero()[0]
            kind = (2 + k) % 3                 # 0 SP, 1 MR, 2 CU
            groups = [(idx, False)]
            if self.seg_start is not None:
                at = self.seg_start[idx, k]
                new = at >= 0
                if new.any():
                    coder.start(idx[new], at[new], self.raw_pass[idx[new], k])
                raw = self.raw_pass[idx, k]
                if raw.any():
                    groups = [(idx[~raw], False), (idx[raw], True)]
            if kind == 0:
                self.flags[idx] &= ~PI
            for sub, raw in groups:
                if len(sub):
                    self._pass(coder, sub, kind, k, raw)
            if self.mag is not None:
                err = self.mag[idx] - (np.abs(self.values[idx]) >> 1)
                self.dist[idx, k + 1] = (err.astype(np.float64) ** 2).sum(1)

    def _pass(self, coder, idx, kind, k, raw):
        """Pass k of lanes idx: the pass, a clean-up's segmentation
        symbol, and the contexts' reset after an MQ pass."""
        plane = self.planes[idx] - 1 - (k + 2) // 3
        lanes = coder.raw_lanes(idx) if raw else coder.lanes(idx)
        if kind == 0:
            self._sigprop(idx, plane, lanes)
        elif kind == 1:
            self._refine(idx, plane, lanes)
        else:
            self._cleanup(idx, plane, lanes)
            seg = (self.style[idx] & SEGSYM) != 0
            if seg.any():
                for _ in range(4):
                    lanes.code(CTX_UNI, seg)
        lanes.close()
        reset = (self.style[idx] & RESET) != 0
        if not raw and reset.any():
            coder.states[idx[reset]] = INITIAL_STATES

    def _significant(self, g, pos, sid, neg, plane):
        """Coefficients at flat positions g (scan positions pos of blocks
        of shape sid, each lane's row at g - pos) become significant
        with sign neg: value +-(3 << plane), their flags and their
        neighbours'."""
        F = self.F
        self.V[g] = (3 - 6 * neg) << plane
        F[g] |= SIG | PI
        t = self.shapes.nbr[sid * (self.N + 1) + pos] + (g - pos)[:, None]
        F[t] |= _SETS + neg[:, None] * _SIGNS

    def _refine(self, idx, plane, lanes):
        pos, cnt = _compact(MR_OK[self.flags[idx, :self.N]], self.N)
        m = pos.shape[1]
        if m == 0:
            return
        g = (idx * self.R)[:, None] + pos
        F, V = self.F, self.V
        ctx = CTX_LUT[(M_REF * 4 + self.orient[idx, None]) * 8192
                      + (F[g] & KEY)]
        on = np.arange(m)[None, :] < cnt[:, None]
        want = None
        if self.mag is not None:
            want = (self.mag.reshape(-1)[g] >> plane[:, None]) & 1
        d = np.zeros(pos.shape, np.int64)
        for j in range(m):
            if np.count_nonzero(on[:, j]) <= TAIL:
                for i in on[:, j].nonzero()[0]:
                    sc = lanes.scalar(i)
                    for jj in range(j, int(cnt[i])):
                        d[i, jj] = sc.code(int(ctx[i, jj]), None if want is
                                           None else int(want[i, jj]))
                    sc.close()
                break
            d[:, j] = lanes.code(ctx[:, j], on[:, j],
                                 None if want is None else want[:, j])
        g = g[on]
        half = np.broadcast_to((1 << plane)[:, None], on.shape)[on]
        v = V[g]
        step = np.where(d[on] == 1, half, -half)
        V[g] = v + np.where(v < 0, -step, step)
        F[g] |= MU

    def _sigprop(self, idx, plane, lanes):
        n = len(idx)
        F = self.F
        row = idx * self.R
        sid = self.shape_id[idx]
        size = self.sizes[idx]
        key = self.orient[idx] * 8192
        ptr = self._next_sp(row, np.zeros(n, np.int64), size)
        live = ptr < size
        sign = np.zeros(n, bool)
        enc = self.mag is not None
        xor = _NO_XOR if lanes.is_raw else XOR_LUT
        while True:
            if np.count_nonzero(live) <= TAIL:
                for i in live.nonzero()[0]:
                    sc = lanes.scalar(i)
                    self._tail_sp(int(idx[i]), sc, int(ptr[i]),
                                  bool(sign[i]), int(plane[i]))
                    sc.close()
                return
            g = row + ptr
            f = F[g] & KEY
            want = None
            if enc:
                want = np.where(sign, self.neg.reshape(-1)[g] ^ XOR_LUT[f],
                                (self.mag.reshape(-1)[g] >> plane) & 1)
            d = lanes.code(CTX_LUT[np.where(sign, M_SIGN * 32768, key) + f],
                           live, want)
            ev = sign.nonzero()[0]
            if len(ev):
                self._significant(g[ev], ptr[ev], sid[ev],
                                  (d[ev] ^ xor[f[ev]]).astype(bool),
                                  plane[ev])
            zero = live & ~sign & (d == 0)
            F[g[zero]] |= PI
            adv = (sign | zero).nonzero()[0]
            sign = live & ~sign & (d == 1)
            if len(adv):
                p = self._next_sp(row[adv], ptr[adv] + 1, size[adv])
                ptr[adv] = p
                live[adv] = p < size[adv]

    def _next_sp(self, row, start, size):
        """The first position at or after start that the significance
        pass codes (insignificant, not visited, a significant neighbour),
        or size where none is left."""
        F = self.F
        ptr = start.copy()
        w = np.arange(WINDOW)
        todo = (ptr < size).nonzero()[0]
        while len(todo):
            p = ptr[todo]
            ok = SP_OK[F[(row[todo] + p)[:, None] + w]]
            first = ok.argmax(1)
            hit = ok[np.arange(len(todo)), first]
            ptr[todo] = np.where(hit, p + first, p + WINDOW)
            todo = todo[~hit]
            todo = todo[ptr[todo] < size[todo]]
        return np.minimum(ptr, size)

    def _cleanup(self, idx, plane, lanes):
        n = len(idx)
        lst, cnt = _compact(CU_OK[self.flags[idx, :self.N]], self.N)
        if lst.shape[1] == 0:
            return
        F = self.F
        lst = np.concatenate([lst, np.full((n, 4), self.N, np.int64)], 1)
        lstf = lst.reshape(-1)
        lrow = np.arange(n) * lst.shape[1]
        row = idx * self.R
        sid = self.shape_id[idx]
        rlrow = sid * (self.N + 1)
        key = self.orient[idx] * 8192
        cur = np.zeros(n, np.int64)
        mode = np.full(n, M_SIG, np.int64)
        r1 = np.zeros(n, np.int64)
        enc = self.mag is not None
        quad = np.arange(4)
        rl_start = self.shapes.rl

        def land(a):
            """Mode of lanes a at their list cursor: a run-length
            decision where a full-stripe column of four uncoded,
            insignificant coefficients with no significant neighbour
            starts, else a significance decision (done past the list)."""
            c = cur[a]
            p = lstf[lrow[a] + c]
            rl = rl_start[rlrow[a] + p]
            if np.count_nonzero(rl):
                b = rl.nonzero()[0]
                rl[b] = QUIET[F[(row[a[b]] + p[b])[:, None] + quad]].all(1)
            mode[a] = np.where(c >= cnt[a], M_DONE,
                               np.where(rl, M_RL, M_SIG))

        land(np.arange(n))
        while True:
            on = mode != M_DONE
            if np.count_nonzero(on) <= TAIL:
                for i in on.nonzero()[0]:
                    sc = lanes.scalar(i)
                    self._tail_cu(int(idx[i]), sc, lst[i].tolist(),
                                  int(cnt[i]), int(cur[i]), int(mode[i]),
                                  int(r1[i]), int(plane[i]))
                    sc.close()
                return
            pos = lstf[lrow + cur]
            g = row + pos
            f = F[g] & KEY
            want = None
            if enc:
                want = self._cleanup_want(g, f, mode, plane, r1)
            d = lanes.code(CTX_LUT[mode * 32768 + key + f], on, want)
            ev = (mode == M_SIGN).nonzero()[0]
            if len(ev):
                self._significant(g[ev], pos[ev], sid[ev],
                                  (d[ev] ^ XOR_LUT[f[ev]]).astype(bool),
                                  plane[ev])
            t = 2 * mode + d
            if np.count_nonzero(_UNI[t]):
                cur += (mode == M_UNI2) * (2 * r1 + d)
                r1 = np.where(mode == M_UNI1, d, r1)
            adv = _ADVANCE[t]
            mode = _NEXT_MODE[t]
            a = adv.nonzero()[0]
            if len(a):
                cur[a] += adv[a]
                land(a)

    def _cleanup_want(self, g, f, mode, plane, r1):
        """The encoder's symbol for each lane's clean-up decision."""
        M = self.mag.reshape(-1)
        bits = (M[g] >> plane) & 1
        sign = self.neg.reshape(-1)[g] ^ XOR_LUT[f]
        quad = (M[g[:, None] + np.arange(4)] >> plane[:, None]) & 1
        first = quad.argmax(1)
        pick = np.stack([bits, sign, bits, quad.any(1), first >> 1,
                         first & 1, bits])
        return pick[mode, np.arange(len(g))]

    # -- the scalar finish of a pass: one lane in Python integers ---------

    def _rows(self, lane):
        """Lane's flags, values (and the encoder's magnitudes and signs)
        as lists, its neighbour table and run-length starts."""
        sid = int(self.shape_id[lane])
        if sid not in self._lists:
            a, b = sid * (self.N + 1), (sid + 1) * (self.N + 1)
            self._lists[sid] = (self.shapes.nbr[a:b].tolist(),
                                self.shapes.rl[a:b].tolist())
        nbr, rl = self._lists[sid]
        enc = self.mag is not None
        return (self.flags[lane].tolist(), self.values[lane].tolist(),
                self.mag[lane].tolist() if enc else None,
                self.neg[lane].tolist() if enc else None, nbr, rl)

    def _sig_scalar(self, F, V, nb, p, neg, plane):
        V[p] = -(3 << plane) if neg else 3 << plane
        F[p] |= SIG | PI
        for q, a, b in zip(nb, _SETS_L, _SIGNS_L):
            F[q] |= a | b if neg else a

    def _tail_sp(self, lane, sc, p, sign, plane):
        """The rest of lane's significance pass from scan position p
        (its sign decision next where `sign`)."""
        F, V, M, NEG, nbr, _ = self._rows(lane)
        size = int(self.sizes[lane])
        key = int(self.orient[lane]) * 8192
        enc = M is not None
        xor = _NO_XOR_L if sc.is_raw else _XOR_L
        while p < size:
            k = F[p] & KEY
            if sign:
                d = sc.code(_CTX_L[M_SIGN * 32768 + k],
                            NEG[p] ^ _XOR_L[k] if enc else None)
                self._sig_scalar(F, V, nbr[p], p, d ^ xor[k], plane)
                sign = False
            else:
                d = sc.code(_CTX_L[key + k], (M[p] >> plane) & 1 if enc
                            else None)
                if d:
                    sign = True
                    continue
                F[p] |= PI
            p += 1
            while p < size and not _SP_OK_L[F[p]]:
                p += 1
        self.flags[lane], self.values[lane] = F, V

    def _tail_cu(self, lane, sc, lst, cnt, c, mode, r1, plane):
        """The rest of lane's clean-up pass from list cursor c in mode."""
        F, V, M, NEG, nbr, rl = self._rows(lane)
        key = int(self.orient[lane]) * 8192
        enc = M is not None
        first = 0
        while mode != M_DONE:
            p = lst[c]
            k = F[p] & KEY
            if mode == M_SIG:
                d = sc.code(_CTX_L[key + k], (M[p] >> plane) & 1 if enc
                            else None)
                if d:
                    mode = M_SIGN
                    continue
                c += 1
            elif mode == M_SIGN:
                d = sc.code(_CTX_L[M_SIGN * 32768 + k],
                            NEG[p] ^ _XOR_L[k] if enc else None)
                self._sig_scalar(F, V, nbr[p], p, d ^ _XOR_L[k], plane)
                c += 1
            elif mode == M_RL:
                if enc:
                    bits = [(M[p + j] >> plane) & 1 for j in range(4)]
                    first = bits.index(1) if 1 in bits else 0
                if sc.code(CTX_RL, int(any(bits)) if enc else None):
                    mode = M_UNI1
                    continue
                c += 4
            elif mode == M_UNI1:
                if enc:
                    first = [(M[p + j] >> plane) & 1
                             for j in range(4)].index(1)
                r1 = sc.code(CTX_UNI, first >> 1 if enc else None)
                mode = M_UNI2
                continue
            else:
                if enc:
                    first = [(M[p + j] >> plane) & 1
                             for j in range(4)].index(1)
                c += 2 * r1 + sc.code(CTX_UNI, first & 1 if enc else None)
                mode = M_SIGN
                continue
            # land: a run-length column or a significance decision
            if c >= cnt:
                mode = M_DONE
            else:
                p = lst[c]
                mode = M_RL if rl[p] and all(
                    _QUIET_L[F[p + j]] for j in range(4)) else M_SIG
        self.flags[lane], self.values[lane] = F, V


class _Recorder:
    """The encoder's side of the passes: records each lane's (context,
    symbol) and returns the symbol, as a decoder would decode it."""

    def __init__(self, n):
        self.n = n
        self.counts = np.zeros(n, np.int64)
        self.ids, self.ctx, self.sym = [], [], []
        self.ends = [[] for _ in range(n)]

    def lanes(self, idx):
        return _RecLanes(self, idx)

    def sequences(self):
        """Each lane's symbols in order: ctx [n, T] (-1 after its end),
        sym [n, T], and per lane the symbol counts at the end of each of
        its passes."""
        T = int(self.counts.max()) if self.n else 0
        ctx = np.full((self.n, T), -1, np.int8)
        sym = np.zeros((self.n, T), np.int8)
        if self.ids:
            ids = np.concatenate(self.ids)
            order = np.argsort(ids, kind="stable")
            ids = ids[order]
            first = np.concatenate([[0], np.cumsum(self.counts)[:-1]])
            rank = np.arange(len(ids)) - first[ids]
            ctx[ids, rank] = np.concatenate(self.ctx)[order]
            sym[ids, rank] = np.concatenate(self.sym)[order]
        return ctx, sym, self.ends


class _RecLanes:
    is_raw = False

    def __init__(self, rec: _Recorder, idx):
        self.rec, self.idx = rec, idx

    def code(self, ctx, on, want):
        want = np.asarray(want, np.int64) & on
        j = on.nonzero()[0]
        if len(j):
            ids = self.idx[j]
            self.rec.ids.append(ids)
            self.rec.ctx.append(ctx[j])
            self.rec.sym.append(want[j])
            self.rec.counts[ids] += 1
        return want

    def close(self):
        for i in self.idx:
            self.rec.ends[i].append(int(self.rec.counts[i]))

    def scalar(self, i):
        return _ScalarRec(self.rec, int(self.idx[i]))


class _ScalarRec:
    """Lane i's recorder in Python lists (the scalar finish of a pass)."""
    is_raw = False

    def __init__(self, rec: _Recorder, lane):
        self.rec, self.lane = rec, lane
        self.ctx, self.sym = [], []

    def code(self, cx, want):
        self.ctx.append(cx)
        self.sym.append(want)
        return want

    def close(self):
        n = len(self.ctx)
        if n:
            rec = self.rec
            rec.ids.append(np.full(n, self.lane, np.int64))
            rec.ctx.append(np.array(self.ctx, np.int64))
            rec.sym.append(np.array(self.sym, np.int64))
            rec.counts[self.lane] += n


def _compact(mask, n):
    """Per row, the column indices where mask holds, in order, padded
    with n: ([rows, max count], counts)."""
    cnt = mask.sum(1)
    m = int(cnt.max()) if len(cnt) else 0
    out = np.full((mask.shape[0], m), n, np.int64)
    r, c = np.nonzero(mask)
    if len(r):
        first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        out[r, np.arange(len(r)) - first[r]] = c
    return out, cnt
