"""HTJ2K's block decoder (ITU-T T.814 / ISO 15444-15) in numpy, read as
OpenCV reads it through OpenJPEG 2.5's ht_dec.c.

An HT code-block holds at most three passes in two segments: the
cleanup segment (Lcup bytes: MagSgn read forward from its start, then
MEL read forward and VLC read backward from its end, Scup = the bytes of
MEL and VLC, 12 bits in the last two bytes) and the refinement segment
(SigProp read forward from its start, MagRef read backward from its
end). The cleanup pass codes quads (2 x 2 samples) in pairs along each
quad row: a quad's significance pattern rho and its EMB bits (u_off,
e_k, e_1) come from a CxtVLC codeword (htj2k_tables.py: one table for
the initial quad row, one for the rest) in the context of its
neighbours, or, in a context of 0, a MEL event first says whether the
quad is significant at all; the U-VLC codes u, and the exponent bound
U_q = kappa + u, kappa from the E_max of the row above; each
significant sample then takes m_n = U_q - e_k bits of MagSgn (its sign
the first), and e_1 gives the implicit top bit. SigProp codes one more
plane of the samples next to significant ones in Part 1's stripe order
(membership bits, then the signs of each four columns' new samples),
MagRef that plane of the cleanup's significant samples.

Each byte stream has its own bit-unstuffing (a stuffed bit after 0xFF
for MagSgn, SigProp and MEL; after a byte above 0x8F, a byte whose seven
low bits are all 1 holds only those seven for VLC and MagRef). Each is
turned into its bit string first (`forward_bits`, `mel_bits`,
`reverse_bits`), as OpenJPEG's readers see them: including where a
stuffed position holds a 1 (OpenJPEG ORs it into the next bit), and the
fill past the data (1s for MagSgn and MEL, 0s for VLC, SigProp and
MagRef).

Values keep OpenJPEG's doubled scale, as utils/ebcot.py's do: with p
the block's planes less its missing MSBs (OpenJPEG's numbps), a cleanup
sample of magnitude mu holds (2 mu + 1) << (p - 1), a SigProp sample
3 << (p - 2), and MagRef sets bit p - 1 and adds 1 << (p - 2).

What OpenJPEG refuses, `Malformed` names (the reader raises IOError for
it): an RGN shift, more than 3 passes, a Scup outside [2, min(Lcup,
4079)], a U_q past the missing MSBs plus 2, a significant sample outside
the block, bad lengths. A block of more than one pass whose refinement
segment is empty, or whose missing MSBs leave no plane below the
cleanup, is decoded from its cleanup pass alone, as OpenJPEG does.

Two routes decode the same: `decode_block` a block at a time in Python
integers, and `HTBlocks` every block of a run as a numpy lane in
lockstep (quad pair by quad pair, then SigProp sample by sample and
MagRef at once), as ebcot.py steps Part 1's passes."""
from __future__ import annotations

import numpy as np

from .htj2k_tables import VLC0, VLC1

MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)
VCAUSAL = 0x08
MASK32 = 0xFFFFFFFF


class Malformed(ValueError):
    """A code-block OpenJPEG refuses to decode (and with it the image)."""


def _decoder_table(table):
    """OpenJPEG's 1,024-entry layout: (context << 7 | 7 VLC bits) ->
    (e_k << 12) | (e_1 << 8) | (rho << 4) | (u_off << 3) | length."""
    out = np.zeros(1024, np.int64)
    for c, cwd, n, rho, u_off, e_k, e_1 in table:
        for hi in range(1 << (7 - n)):
            out[(c << 7) | (hi << n) | cwd] = \
                (e_k << 12) | (e_1 << 8) | (rho << 4) | (u_off << 3) | n
    return out


def _entry_ids(table):
    """The codeword (its index in the table) each index decodes."""
    out = np.zeros(1024, np.int64)
    for i, (c, cwd, n, *_) in enumerate(table):
        for hi in range(1 << (7 - n)):
            out[(c << 7) | (hi << n) | cwd] = i
    return out


TABLE = (_decoder_table(VLC0), _decoder_table(VLC1))
_TABLE_L = (TABLE[0].tolist(), TABLE[1].tolist())
ENTRY = (_entry_ids(VLC0), _entry_ids(VLC1))
# a set that collects (table, codeword) of each codeword decoded (0 for
# VLC0, 1 for VLC1); None: nothing is collected
seen = None

# the U-VLC prefix by the next three bits (T.814 Table 3): prefix
# length, suffix length, prefix value
_UVLC = ((3, 5, 5), (1, 0, 1), (2, 0, 2), (1, 0, 1), (3, 1, 3), (1, 0, 1),
         (2, 0, 2), (1, 0, 1))
_UPL = np.array([d[0] for d in _UVLC], np.int64)
_USL = np.array([d[1] for d in _UVLC], np.int64)
_UPV = np.array([d[2] for d in _UVLC], np.int64)


# ---------------------------------------------------------------------------
# the bit strings of the byte streams
# ---------------------------------------------------------------------------

def _rows(data):
    return np.frombuffer(bytes(data), np.uint8).astype(np.int64)


def _pick(bits8, n, carry):
    """Each byte's first n bits of its 8 (rows of bits8), the carry
    ORed into the next byte's first, flattened."""
    if len(n) > 1:
        bits8[1:, 0] |= carry[:-1]
    keep = np.arange(8)[None, :] < n[:, None]
    return bits8[keep].astype(np.uint8)


def forward_bits(data, fill):
    """MagSgn (fill 0xFF) and SigProp (fill 0): bits LSB first; a byte
    after 0xFF gives its 7 low bits, its MSB ORed into the next bit
    (OpenJPEG's frwd_read). One fill byte is included; past it, every
    bit is the fill's."""
    d = np.concatenate([_rows(data), [fill]])
    after = np.concatenate([[False], d[:-1] == 0xFF])
    n = np.where(after, 7, 8)
    bits8 = (d[:, None] >> np.arange(8)[None, :]) & 1
    return _pick(bits8, n, np.where(after, d >> 7, 0))


def mel_bits(data):
    """MEL's bits, MSB first: the bytes given (the last ORed with 0xF by
    the caller), 7 bits of a byte after 0xFF (its MSB dropped: OpenJPEG
    ORs it into the 1 before it); one 0xFF fill byte."""
    d = np.concatenate([_rows(data), [0xFF]])
    after = np.concatenate([[False], d[:-1] == 0xFF])
    bits8 = (d[:, None] >> np.arange(7, -1, -1)[None, :]) & 1
    bits8 = np.where(after[:, None], np.roll(bits8, -1, 1), bits8)
    keep = np.arange(8)[None, :] < np.where(after, 7, 8)[:, None]
    return bits8[keep].astype(np.uint8)


def reverse_bits(data, nibble):
    """VLC (nibble: data[0] is the byte before Scup's, of which only the
    upper half is VLC's) and MagRef: bytes in reading order (from the end
    of the segment backward), bits LSB first; after a byte above 0x8F, a
    byte whose 7 low bits are all 1 gives those 7, its MSB ORed into the
    next bit (OpenJPEG's rev_read). One zero fill byte is included."""
    d = _rows(data)
    head = np.zeros(0, np.uint8)
    carry0, unstuff0 = 0, True
    if nibble:
        t = int(d[0]) >> 4
        k = 3 if (t & 7) == 7 else 4
        head = np.array([(t >> j) & 1 for j in range(k)], np.uint8)
        carry0 = (t >> 3) & 1 if k == 3 else 0
        unstuff0 = (int(d[0]) | 0xF) > 0x8F
        d = d[1:]
    d = np.concatenate([d, [0]])
    prev = np.concatenate([[unstuff0], d[:-1] > 0x8F])
    seven = prev & ((d & 0x7F) == 0x7F)
    bits8 = (d[:, None] >> np.arange(8)[None, :]) & 1
    bits8[0, 0] |= carry0
    body = _pick(bits8, np.where(seven, 7, 8), np.where(seven, d >> 7, 0))
    return np.concatenate([head, body])


class _Bits:
    """A bit string read LSB first: peek(n) the next n bits as an
    integer (past the string, the fill's bits), advance(n)."""

    def __init__(self, bits, fill):
        self.b, self.pos = bits.tolist(), 0
        self.fill = fill

    def peek(self, n):
        v, b, p = 0, self.b, self.pos
        for j in range(n):
            v |= (b[p + j] if p + j < len(b) else self.fill) << j
        return v

    def advance(self, n):
        self.pos += n


class _Mel:
    """MEL's run decoder as OpenJPEG keeps it: a run r is 2 x (zero
    events) + 1 where a one event ends it; each event takes 2 from r,
    and r = -1 is a one."""

    def __init__(self, bits):
        self.b, self.pos, self.k = bits.tolist(), 0, 0
        self.run = self._next()

    def _bit(self):
        v = self.b[self.pos] if self.pos < len(self.b) else 1
        self.pos += 1
        return v

    def _next(self):
        e = MEL_EXP[self.k]
        if self._bit():
            self.k = min(self.k + 1, 12)
            return ((1 << e) - 1) << 1
        r = 0
        for _ in range(e):
            r = (r << 1) | self._bit()
        self.k = max(self.k - 1, 0)
        return (r << 1) + 1

    def event(self):
        self.run -= 2
        one = self.run == -1
        if self.run < 0:
            self.run = self._next()
        return one


def _uvlc(vlc, mode, initial):
    """(u0, u1, bits used) of a quad pair's U-VLC (OpenJPEG's
    decode_init_uvlc / decode_noninit_uvlc); u already counts the 1 of
    kappa."""
    if mode == 0:
        return 1, 1, 0
    pl, sl, pv = _UVLC[vlc & 7]
    if mode <= 2:
        vlc >>= pl
        d = pv + (vlc & ((1 << sl) - 1))
        return (d + 1, 1, pl + sl) if mode == 1 else (1, d + 1, pl + sl)
    used = pl
    vlc >>= pl
    if initial and mode == 3 and pl > 2:
        u1 = (vlc & 1) + 2
        vlc >>= 1
        d1 = pv + (vlc & ((1 << sl) - 1))
        return d1 + 1, u1, used + 1 + sl
    pl2, sl2, pv2 = _UVLC[vlc & 7]
    vlc >>= pl2
    used += pl2
    d1 = pv + (vlc & ((1 << sl) - 1))
    vlc >>= sl
    d2 = pv2 + (vlc & ((1 << sl2) - 1))
    add = 3 if mode == 4 else 1
    return d1 + add, d2 + add, used + sl + sl2


# ---------------------------------------------------------------------------
# the checks before a block is decoded
# ---------------------------------------------------------------------------

class Block:
    """One HT code-block as tier-2 leaves it: its bytes (every chunk in
    the order the packets gave them; None where no packet gave it a
    chunk, even an empty one), the lengths of its first two
    segments and their passes, Mb (the band's planes) and numbps (Mb less
    the missing MSBs), its shape, style and RGN shift."""
    __slots__ = ("data", "len1", "len2", "passes", "Mb", "numbps", "h", "w",
                 "style", "shift")

    def __init__(self, data, len1, len2, passes, Mb, numbps, h, w, style=0,
                 shift=0):
        self.data, self.len1, self.len2 = data, len1, len2
        self.passes, self.Mb, self.numbps = passes, Mb, numbps
        self.h, self.w, self.style, self.shift = h, w, style, shift


def prepare(b: Block):
    """OpenJPEG's checks before decoding (opj_t1_ht_decode_cblk): None for
    a block that stays zero, else (passes, p, zero planes + 1, Lcup,
    Scup) with the passes that are decoded."""
    if b.shift:
        raise Malformed("ROI (an RGN shift) in an HT code-block")
    if b.Mb == 0 or b.data is None:
        return None
    zero = b.Mb + 1 - b.numbps               # missing MSBs + 1
    passes = b.passes
    if passes > 1 and b.len2 == 0:
        passes = 1
    if passes > 3:
        raise Malformed(f"{passes} coding passes in an HT code-block")
    if b.Mb > 30:
        raise Malformed(f"{b.Mb} bit-planes in an HT code-block")
    if zero > b.Mb:
        raise Malformed(f"{zero} zero bit-planes of {b.Mb} in an HT "
                        "code-block")
    if zero == b.Mb and passes > 1:
        passes = 1
    n = len(b.data)
    if b.len1 < 2 or b.len1 > n or b.len1 + b.len2 > n:
        raise Malformed("HT code-block lengths")
    lcup = b.len1
    scup = (b.data[lcup - 1] << 4) + (b.data[lcup - 2] & 0xF)
    if scup < 2 or scup > lcup or scup > 4079:
        raise Malformed(f"Scup {scup} of an HT cleanup segment of {lcup}")
    # OpenJPEG's mel_init refuses a byte above 0x8F after 0xFF among the
    # first bytes it reads (up to 4, by the buffer's alignment: here as for
    # a block whose data starts on a 4-byte boundary); it reads MEL's last
    # byte ORed with 0xF and 0xFF past it, but checks the byte in memory,
    # its pointer stopping at Scup's high byte
    at, size, unstuff = lcup - scup, scup - 1, False
    for _ in range(4 - (at & 3)):
        if unstuff and b.data[at] > 0x8F:
            raise Malformed("the MEL segment of an HT code-block")
        d = b.data[at] if size > 0 else 0xFF
        if size == 1:
            d |= 0xF
        if size > 0:
            at += 1
        size -= 1
        unstuff = d == 0xFF
    return passes, b.numbps, zero, lcup, scup


def streams(b: Block, lcup, scup):
    """The bit strings of MagSgn, MEL, VLC, SigProp and MagRef."""
    d = b.data
    mel = bytearray(d[lcup - scup:lcup - 1])
    if mel:
        mel[-1] |= 0xF
    return (forward_bits(d[:lcup - scup], 0xFF), mel_bits(mel),
            reverse_bits(d[lcup - scup:lcup - 1][::-1], True),
            forward_bits(d[lcup:lcup + b.len2], 0),
            reverse_bits(d[lcup:lcup + b.len2][::-1], False))


# ---------------------------------------------------------------------------
# one block in Python integers
# ---------------------------------------------------------------------------

def decode_block(b: Block):
    """Block b's coefficients in OpenJPEG's doubled scale, [h, w] int64."""
    h, w = b.h, b.w
    out = np.zeros((h, w), np.int64)
    ready = prepare(b)
    if ready is None:
        return out
    passes, p, zero, lcup, scup = ready
    ms_b, mel_b, vlc_b, sp_b, mr_b = streams(b, lcup, scup)
    ms, vlc, mel = _Bits(ms_b, 1), _Bits(vlc_b, 0), _Mel(mel_b)
    word = [[0] * w for _ in range(h)]        # OpenJPEG's sign | value
    E = [[0] * (w + 4) for _ in range(h)]     # exponents, 1 column left
    sig = [[0] * (w + 4) for _ in range(h)]
    for r in range((h + 1) // 2):
        y0 = 2 * r
        initial = r == 0
        table = _TABLE_L[0 if initial else 1]
        c_prev = 0
        for x in range(0, w, 4):
            qinf = [0, 0]
            for k in (0, 1):
                c0 = x + 2 * k
                if k and c0 >= w:
                    break
                if initial:
                    c = c_prev
                else:
                    up = sig[y0 - 1]
                    c = (up[c0] | up[c0 + 1]) | (c_prev << 1) | \
                        ((up[c0 + 2] | up[c0 + 3]) << 2)
                at = (c << 7) | vlc.peek(7)
                t = table[at]
                if c == 0 and not mel.event():
                    t = 0
                if t and seen is not None:
                    tab = 0 if initial else 1
                    seen.add((tab, int(ENTRY[tab][at])))
                vlc.advance(t & 7)
                qinf[k] = t
                rho = (t >> 4) & 15
                if initial:
                    c_prev = (rho & 1) | ((rho >> 1) & 1) | \
                        ((rho >> 2) & 1) << 1 | ((rho >> 3) & 1) << 2
                else:
                    c_prev = int((rho & 12) != 0)
            mode = ((qinf[0] >> 3) & 1) | (((qinf[1] >> 3) & 1) << 1)
            if initial and mode == 3 and mel.event():
                mode = 4
            v32 = vlc.peek(32)
            u0, u1, used = _uvlc(v32, mode, initial)
            vlc.advance(used)
            U = [u0, u1]
            if not initial:
                for k in (0, 1):
                    rho = (qinf[k] >> 4) & 15
                    if rho & (rho - 1):
                        c0 = x + 2 * k
                        e = max(E[y0 - 1][c0:c0 + 4])
                        U[k] += e - 2 if e > 2 else 0
            if U[0] > zero + 1 or U[1] > zero + 1:
                raise Malformed("U_q past the missing MSBs of an HT "
                                "code-block")
            for k in (0, 1):
                rho = (qinf[k] >> 4) & 15
                for n in range(4):
                    yy, xx = y0 + (n & 1), x + 2 * k + (n >> 1)
                    if rho >> n & 1 and (yy >= h or xx >= w):
                        raise Malformed("a significant sample outside an HT "
                                        "code-block")
            for k in (0, 1):
                t = qinf[k]
                for n in range(4):
                    if not (t >> (4 + n)) & 1:
                        continue
                    yy, xx = y0 + (n & 1), x + 2 * k + (n >> 1)
                    v = ms.peek(32)
                    m = U[k] - ((t >> (12 + n)) & 1)
                    ms.advance(m)
                    vn = (v & ((1 << m) - 1)) | (((t >> (8 + n)) & 1) << m) | 1
                    word[yy][xx] = ((v & 1) << 31) | \
                        ((((vn + 2) & MASK32) << (p - 1)) & MASK32)
                    E[yy][xx + 1] = vn.bit_length()
                    sig[yy][xx + 1] = 1
    if passes > 1:
        sig_c = np.array([row[1:w + 1] for row in sig], bool)
        _refine_scalar(word, sig_c, passes, p, bool(b.style & VCAUSAL),
                       _Bits(sp_b, 0), _Bits(mr_b, 0))
    wd = np.array(word, np.int64).reshape(h, w)
    mag = wd & 0x7FFFFFFF
    return np.where(wd >> 31 != 0, -mag, mag)


def _refine_scalar(word, sig, passes, p, causal, sp, mr):
    """SigProp and MagRef of one block, stripe by stripe."""
    h, w = sig.shape
    new = np.zeros((h, w), bool)
    half = 1 << (p - 2)
    val = 3 << (p - 2)
    for s in range(0, h, 4):
        rows = range(s, min(s + 4, h))
        if passes > 2:
            for j in range(w):
                for i in rows:
                    if sig[i, j]:
                        bit = mr.peek(1)
                        mr.advance(1)
                        word[i][j] ^= (1 - bit) << (p - 1)
                        word[i][j] |= half
        for g in range(0, w, 4):
            fresh = []
            for j in range(g, min(g + 4, w)):
                for i in rows:
                    if sig[i, j]:
                        continue
                    y0, y1 = max(i - 1, 0), min(i + 2, h)
                    if causal and i == s + 3:
                        y1 = min(y1, s + 4)
                    x0, x1 = max(j - 1, 0), min(j + 2, w)
                    if not (sig[y0:y1, x0:x1].any() or
                            new[max(i - 1, 0):min(i + 2, h), x0:x1].any()):
                        continue
                    bit = sp.peek(1)
                    sp.advance(1)
                    if bit:
                        new[i, j] = True
                        fresh.append((i, j))
            for i, j in fresh:
                word[i][j] = (sp.peek(1) << 31) | val
                sp.advance(1)


# ---------------------------------------------------------------------------
# many blocks in lockstep
# ---------------------------------------------------------------------------

# runs of at most this many blocks go a block at a time in Python
# integers (a lockstep step costs about as much as a few blocks' worth of
# Python for one quad pair)
SCALAR = 2


class _Lanes:
    """One bit string a lane, concatenated: `win(pos)` the 32 bits from
    each lane's position (LSB first, the fill's past its string), or for
    MEL (msb) the 6 bits, MSB first."""

    def __init__(self, strings, fill, msb=False):
        n = np.array([len(b) for b in strings], np.int64)
        self.off = np.concatenate([[0], np.cumsum(n + 32)[:-1]])
        self.end = self.off + n
        pad = np.full(32, fill, np.uint8)
        flat = np.concatenate([x for b in strings for x in (b, pad)]) \
            .astype(np.int64)
        width = 6 if msb else 32
        w = np.zeros(len(flat), np.int64)
        for j in range(width):
            sh = (width - 1 - j) if msb else j
            w[:len(flat) - j] |= flat[j:] << sh
            if j:
                w[len(flat) - j:] |= fill << sh
        self.w = w
        self.pos = np.zeros(len(strings), np.int64)

    def win(self, lanes):
        return self.w[np.minimum(self.off[lanes] + self.pos[lanes],
                                 self.end[lanes])]


class HTBlocks:
    """The blocks of a run as lanes: every lane steps through its quad
    pairs together (a lane past its block idles), then SigProp sample by
    sample in stripe order, then MagRef at once."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.out = [np.zeros((b.h, b.w), np.int64) for b in blocks]
        ready = [(i, prepare(b)) for i, b in enumerate(blocks)]
        self.live = [(i, r) for i, r in ready if r is not None]

    def decode(self):
        if not self.live:
            return self.out
        idx = [i for i, _ in self.live]
        L = len(idx)
        bl = [self.blocks[i] for i in idx]
        par = np.array([r for _, r in self.live], np.int64)
        passes, p, zero = par[:, 0], par[:, 1], par[:, 2]
        st = [streams(b, int(r[3]), int(r[4])) for b, (_, r) in
              zip(bl, self.live)]
        self.h = np.array([b.h for b in bl], np.int64)
        self.w = np.array([b.w for b in bl], np.int64)
        H, W = int(self.h.max()), int(self.w.max())
        ms = _Lanes([x[0] for x in st], 1)
        vlc = _Lanes([x[2] for x in st], 0)
        self.mel = _Lanes([x[1] for x in st], 1, msb=True)
        self.mk = np.zeros(L, np.int64)
        self.run = np.zeros(L, np.int64)
        self._mel_next(np.arange(L))
        # significance and exponents, a row above and a column left (and
        # room on the right for a last pair's second quad)
        sig = np.zeros((L, H + 1, W + 8), np.int64)
        E = np.zeros((L, H + 1, W + 8), np.int64)
        word = np.zeros((L, H, W), np.int64)
        lanes = np.arange(L)
        for r in range((H + 1) // 2):
            y0 = 2 * r
            initial = r == 0
            table = TABLE[0 if initial else 1]
            c_prev = np.zeros(L, np.int64)
            for x in range(0, W, 4):
                act = (y0 < self.h) & (x < self.w)
                if not act.any():
                    continue
                qinf = []
                for k in (0, 1):
                    c0 = x + 2 * k
                    has = act & (c0 < self.w)
                    if initial:
                        c = c_prev
                    else:
                        up = sig[:, y0]
                        c = (up[:, c0] | up[:, c0 + 1]) | (c_prev << 1) | \
                            ((up[:, c0 + 2] | up[:, c0 + 3]) << 2)
                    at = (c << 7) | (vlc.win(lanes) & 0x7F)
                    t = table[at]
                    zc = has & (c == 0)
                    if zc.any():
                        ev = np.zeros(L, bool)
                        ev[zc] = self._mel_event(zc.nonzero()[0])
                        t = np.where(zc & ~ev, 0, t)
                    t = np.where(has, t, 0)
                    if seen is not None:
                        tab = 0 if initial else 1
                        seen.update((tab, int(e)) for e in
                                    np.unique(ENTRY[tab][at[t != 0]]))
                    vlc.pos += t & 7
                    qinf.append(t)
                    rho = (t >> 4) & 15
                    if initial:
                        c_prev = (rho & 1) | ((rho >> 1) & 1) | \
                            ((rho >> 2) & 1) << 1 | ((rho >> 3) & 1) << 2
                    else:
                        c_prev = ((rho & 12) != 0).astype(np.int64)
                mode = ((qinf[0] >> 3) & 1) | (((qinf[1] >> 3) & 1) << 1)
                if initial:
                    m3 = act & (mode == 3)
                    if m3.any():
                        ev = np.zeros(L, bool)
                        ev[m3] = self._mel_event(m3.nonzero()[0])
                        mode = np.where(m3 & ev, 4, mode)
                u0, u1, used = _uvlc_lanes(vlc.win(lanes), mode, initial)
                vlc.pos += np.where(act, used, 0)
                U = [u0, u1]
                if not initial:
                    for k in (0, 1):
                        rho = (qinf[k] >> 4) & 15
                        c0 = x + 2 * k
                        e = E[:, y0, c0:c0 + 4].max(1)
                        add = ((rho & (rho - 1)) != 0) & (e > 2)
                        U[k] = U[k] + np.where(add, e - 2, 0)
                if (act & ((U[0] > zero + 1) | (U[1] > zero + 1))).any():
                    raise Malformed("U_q past the missing MSBs of an HT "
                                    "code-block")
                for k in (0, 1):
                    t = qinf[k]
                    for n in range(4):
                        on = ((t >> (4 + n)) & 1) != 0
                        if not on.any():
                            continue
                        yy, xx = y0 + (n & 1), x + 2 * k + (n >> 1)
                        if (on & ((yy >= self.h) | (xx >= self.w))).any():
                            raise Malformed("a significant sample outside "
                                            "an HT code-block")
                        j = on.nonzero()[0]
                        v = ms.win(j)
                        m = U[k][j] - ((t[j] >> (12 + n)) & 1)
                        ms.pos[j] += m
                        vn = (v & ((1 << m) - 1)) | \
                            (((t[j] >> (8 + n)) & 1) << m) | 1
                        word[j, yy, xx] = ((v & 1) << 31) | \
                            ((((vn + 2) & MASK32) << (p[j] - 1)) & MASK32)
                        E[j, yy + 1, xx + 1] = np.frexp(
                            vn.astype(np.float64))[1]
                        sig[j, yy + 1, xx + 1] = 1
        ref = (passes > 1).nonzero()[0]
        if len(ref):
            sub = [st[i] for i in ref]
            self._refine(word, sig[:, 1:, 1:W + 1] != 0, ref, passes, p,
                         np.array([bool(bl[i].style & VCAUSAL) for i in ref]),
                         _Lanes([x[3] for x in sub], 0),
                         _Lanes([x[4] for x in sub], 0))
        mag = word & 0x7FFFFFFF
        vals = np.where(word >> 31 != 0, -mag, mag)
        for lane, i in enumerate(idx):
            b = self.blocks[i]
            self.out[i] = vals[lane, :b.h, :b.w]
        return self.out

    # -- MEL --------------------------------------------------------------

    def _mel_next(self, j):
        """Lanes j decode their next MEL run."""
        e = np.array(MEL_EXP)[self.mk[j]]
        v = self.mel.win(j)
        one = (v >> 5) & 1
        r = (v >> (5 - e)) & ((1 << e) - 1)
        self.run[j] = np.where(one != 0, ((1 << e) - 1) << 1, (r << 1) + 1)
        self.mel.pos[j] += np.where(one != 0, 1, 1 + e)
        self.mk[j] = np.where(one != 0, np.minimum(self.mk[j] + 1, 12),
                              np.maximum(self.mk[j] - 1, 0))

    def _mel_event(self, j):
        self.run[j] -= 2
        one = self.run[j] == -1
        more = j[self.run[j] < 0]
        if len(more):
            self._mel_next(more)
        return one

    # -- SigProp and MagRef -----------------------------------------------

    def _refine(self, word, sig, ref, passes, p, causal, sp, mr):
        """SigProp (and MagRef where 3 passes) of lanes `ref`."""
        h, w = self.h[ref], self.w[ref]
        H, W = int(h.max()), int(w.max())
        sigc = np.zeros((len(ref), H + 2, W + 2), bool)
        sigc[:, 1:H + 1, 1:W + 1] = sig[ref, :H, :W]
        new = np.zeros_like(sigc)
        pr, pp = passes[ref], p[ref]
        half, val = 1 << (pp - 2), 3 << (pp - 2)
        wd = word[ref]
        # MagRef: the cleanup's significant samples in stripe order
        three = pr > 2
        if three.any():
            yy, xx = np.mgrid[0:H, 0:W]
            yy, xx = yy.ravel(), xx.ravel()
            order = np.lexsort((yy, xx, yy // 4))
            ys, xs = yy[order], xx[order]
            s = sigc[:, 1 + ys, 1 + xs] & three[:, None]
            k = np.cumsum(s, 1) - 1
            at = np.minimum(mr.off[:, None] + k, mr.end[:, None])
            bit = mr.w[at] & 1
            old = wd[:, ys, xs]
            newv = (old ^ ((1 - bit) << (pp[:, None] - 1))) | half[:, None]
            wd[:, ys, xs] = np.where(s, newv, old)
        # membership from the cleanup's significance: the 8 neighbours,
        # but a stripe's last row sees nothing of the stripe below in a
        # vertically causal block
        above = np.zeros_like(sigc)
        static = np.zeros_like(sigc)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    part = sigc[:, 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx]
                    static[:, 1:H + 1, 1:W + 1] |= part
                    if dy < 1:
                        above[:, 1:H + 1, 1:W + 1] |= part
        last = ((np.arange(H + 2) - 1) % 4 == 3)[None, :, None] & \
            causal[:, None, None]
        static = np.where(last, above, static)
        for s0 in range(0, H, 4):
            for g in range(0, W, 4):
                fresh = []
                for j in range(g, min(g + 4, W)):
                    for i in range(s0, min(s0 + 4, H)):
                        act = (i < h) & (j < w) & ~sigc[:, i + 1, j + 1]
                        nb = static[:, i + 1, j + 1] | \
                            new[:, i:i + 3, j:j + 3].any((1, 2))
                        m = (act & nb).nonzero()[0]
                        if not len(m):
                            continue
                        bit = sp.win(m) & 1
                        sp.pos[m] += 1
                        got = m[bit != 0]
                        if len(got):
                            new[got, i + 1, j + 1] = True
                            fresh.append((i, j, got))
                for i, j, got in fresh:
                    sgn = sp.win(got) & 1
                    sp.pos[got] += 1
                    wd[got, i, j] = (sgn << 31) | val[got]
        word[ref] = wd


def _uvlc_lanes(v, mode, initial):
    """`_uvlc` over lanes."""
    pl, sl, pv = _UPL[v & 7], _USL[v & 7], _UPV[v & 7]
    v1 = v >> pl
    one = pv + (v1 & ((1 << sl) - 1))
    u0 = np.where(mode == 1, one + 1, 1)
    u1 = np.where(mode == 2, one + 1, 1)
    used = np.where((mode == 1) | (mode == 2), pl + sl, 0)
    a = (mode == 3) & (pl > 2) if initial else np.zeros(len(v), bool)
    a_u1 = (v1 & 1) + 2
    a_d1 = pv + ((v1 >> 1) & ((1 << sl) - 1))
    pl2, sl2, pv2 = _UPL[v1 & 7], _USL[v1 & 7], _UPV[v1 & 7]
    v2 = v1 >> pl2
    d1 = pv + (v2 & ((1 << sl) - 1))
    d2 = pv2 + ((v2 >> sl) & ((1 << sl2) - 1))
    add = np.where(mode == 4, 3, 1)
    b = (mode >= 3) & ~a
    u0 = np.where(a, a_d1 + 1, np.where(b, d1 + add, u0))
    u1 = np.where(a, a_u1, np.where(b, d2 + add, u1))
    used = np.where(a, pl + 1 + sl, np.where(b, pl + pl2 + sl + sl2, used))
    return u0, u1, used

def decode_blocks(blocks):
    """Every block's coefficients ([h, w] int64 each): in lockstep, or a
    block at a time for a run of at most SCALAR blocks."""
    if len(blocks) <= SCALAR:
        return [decode_block(b) for b in blocks]
    return HTBlocks(blocks).decode()
