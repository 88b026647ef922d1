"""A hand-written HTJ2K encoder (ITU-T T.814 / ISO 15444-15) for the
port's test fixtures: the HT block coder (the cleanup pass with its MEL,
VLC, U-VLC and MagSgn coders, and the SigProp and MagRef passes), HT
packet headers, and the code stream (SIZ with the Part 15 Rsiz bit, CAP,
CPF, COD / COC with code-block style 0x40, QCD / QCC, SOT / SOD, EOC),
raw or in JP2 boxes (`jp2 ` or `jph ` brand).

The port itself writes no HTJ2K (ignis_tpu's save_image writes none);
this lives under scripts/ for scripts/make_htj2k_fixtures.py, the fuzz
(scripts/torch_image_fuzz.py) and tests/test_torch_htj2k.py. Every
stream rule here is the inverse of what OpenJPEG's ht_dec.c reads, and
OpenCV (cv2, with OpenJPEG 2.5.3) judges each file the fixtures script
writes.

Coefficients are integers in units of plane 0; a block's cleanup pass
codes every magnitude bit from its most significant down to plane P
(`plane`), SigProp and MagRef one plane more (P - 1), as T.814 sets
them. The packet header's "zero bit-planes" of an HT block is its
missing MSBs, Mb - 1 - P."""
from __future__ import annotations

import struct

import numpy as np

from ignis_tpu_torch.utils import jpeg2000 as j2k
from ignis_tpu_torch.utils.htj2k_tables import VLC0, VLC1

MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)
LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
GUARD = 2


def _table_index(table):
    """(context, rho, u_off) -> [(e_k, e_1, codeword, length, entry)]."""
    out = {}
    for i, (c, cwd, n, rho, u_off, e_k, e_1) in enumerate(table):
        out.setdefault((c, rho, u_off), []).append((e_k, e_1, cwd, n, i))
    return out


TABLES = (_table_index(VLC0), _table_index(VLC1))


def _popcount(x):
    return bin(x).count("1")


def uvlc_bits(u):
    """T.814's U-VLC of u (1 to 36): (prefix bits, suffix value, suffix
    length), the bits in the order they are written."""
    if u == 1:
        return [1], 0, 0
    if u == 2:
        return [0, 1], 0, 0
    if u <= 4:
        return [0, 0, 1], u - 3, 1
    if u <= 36:
        return [0, 0, 0], u - 5, 5
    raise ValueError(f"U-VLC of {u}")


# ---------------------------------------------------------------------------
# the byte-stream writers, each the inverse of its reader in ht_dec.c
# ---------------------------------------------------------------------------

def pack_forward(bits, fill):
    """MagSgn (fill 1) and SigProp (fill 0): bits LSB first; after a 0xFF
    byte the next holds 7 bits (its MSB a stuffed 0). The last byte is
    padded with `fill`; trailing 0xFF bytes (which the MagSgn reader
    supplies itself) go, and a SigProp that would end on 0xFF gets a
    zero byte."""
    out = bytearray()
    cur = n = 0
    cap = 8
    for b in bits:
        cur |= b << n
        n += 1
        if n == cap:
            out.append(cur)
            cap = 7 if cur == 0xFF else 8
            cur = n = 0
    if n:
        if fill:
            cur |= ((1 << (cap - n)) - 1) << n
        out.append(cur)
    if fill:
        while out and out[-1] == 0xFF:
            out.pop()
    elif out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def pack_mel(bits):
    """MEL: bits MSB first; after 0xFF the next byte holds 7 bits. Never
    ends on 0xFF (the reader would then unstuff the VLC byte after it)."""
    out = bytearray()
    cur = n = 0
    cap = 8
    for b in bits:
        cur = (cur << 1) | b
        n += 1
        if n == cap:
            out.append(cur)
            cap = 7 if cur == 0xFF else 8
            cur = n = 0
    if n:
        out.append(cur << (cap - n))
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def pack_backward(bits, first_nibble):
    """VLC (first_nibble: the first byte holds its bits above a nibble of
    1s, which Scup overwrites) and MagRef: bits LSB first into bytes
    written from the end backward; after a byte above 0x8F, a byte whose
    7 low bits are all 1 holds only those 7 (its MSB a stuffed 0).
    Returns the bytes in memory order (the first written last)."""
    out = []
    cur, n = (0xF, 4) if first_nibble else (0, 0)
    cap, gt8f = 7, True
    for b in bits:
        cur |= b << n
        n += 1
        if n < cap:
            continue
        if cap == 7 and cur != 0x7F:
            cap = 8                   # the eighth bit is free
            continue
        out.append(cur)
        gt8f = cur > 0x8F
        cur, n, cap = 0, 0, (7 if gt8f else 8)
    if n or (first_nibble and not out):
        out.append(cur)
    return bytes(out[::-1])


# ---------------------------------------------------------------------------
# the HT block coder
# ---------------------------------------------------------------------------

class MEL:
    """T.814's MEL coder of the zero-context and pair events."""

    def __init__(self):
        self.bits, self.k, self.run = [], 0, 0
        self.states = {0}

    def event(self, e):
        if not e:
            self.run += 1
            if self.run >= 1 << MEL_EXP[self.k]:
                self.bits.append(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.states.add(self.k)
        else:
            t = MEL_EXP[self.k]
            self.bits.append(0)
            self.bits.extend((self.run >> (t - 1 - j)) & 1 for j in range(t))
            self.run = 0
            self.k = max(0, self.k - 1)
            self.states.add(self.k)

    def finish(self):
        if self.run:
            self.bits.append(1)
        return pack_mel(self.bits)


def _bitlen(x):
    return int(x).bit_length()


def cleanup_segment(q, plane, causal=False, pick=None, used=None):
    """The HT cleanup segment of a block of integer coefficients q [h, w]
    down to `plane`: MagSgn, then MEL, then the VLC written backward,
    Scup in the last two bytes. `pick(initial, c, rho, emb, options)` may
    choose the VLC entry among those that fit (the table walker); else
    the one with the most e_k bits. `used` collects what the segment
    exercises: (table, entry) of each codeword, ("mel", state) of each
    MEL state, ("u", initial row, u) of each U-VLC value and ("pair",
    rule) of each initial-row pair rule ("both>2" after a MEL one,
    "first>2" and "first<=2" after a MEL zero)."""
    h, w = q.shape
    mag = np.abs(q).astype(np.int64) >> plane
    sig = mag > 0
    neg = (q < 0)
    v = np.where(sig, 2 * (mag - 1) + neg, 0)
    E = np.zeros((h, w), np.int64)
    for (y, x) in zip(*np.nonzero(sig)):
        E[y, x] = _bitlen(2 * (mag[y, x] - 1) + 1)
    # padded views: a column left, three right, one row above
    sp = np.zeros((h + 2, w + 4), bool)
    sp[1:h + 1, 1:w + 1] = sig
    ep = np.zeros((h + 2, w + 4), np.int64)
    ep[1:h + 1, 1:w + 1] = E
    mel, vlc, ms = MEL(), [], []
    for r in range((h + 1) // 2):
        initial = r == 0
        c_prev = 0
        y0 = 2 * r
        for x in range(0, w, 4):
            quads = []
            for k in (0, 1):
                c0 = x + 2 * k
                if k == 1 and c0 >= w:
                    quads.append(None)
                    continue
                rho = 0
                for n in range(4):
                    yy, xx = y0 + (n & 1), c0 + (n >> 1)
                    if yy < h and xx < w and sig[yy, xx]:
                        rho |= 1 << n
                quads.append((c0, rho))
            info = []
            for k, qd in enumerate(quads):
                if qd is None:
                    info.append(None)
                    continue
                c0, rho = qd
                if initial:
                    c = c_prev
                else:
                    # bit 0: NW, N (row above, cols c0-1, c0); bit 1: W
                    # and SW (the quad before, its right column); bit 2:
                    # N, NE (row above, cols c0+1, c0+2)
                    c = int(sp[y0, c0] or sp[y0, c0 + 1]) \
                        | (c_prev << 1) \
                        | (int(sp[y0, c0 + 2] or sp[y0, c0 + 3]) << 2)
                Es = [E[y0 + (n & 1), c0 + (n >> 1)]
                      if rho >> n & 1 else 0 for n in range(4)]
                emax = max(Es)
                kappa = 1
                if not initial and _popcount(rho) > 1:
                    above = int(ep[y0, c0:c0 + 4].max())
                    kappa = max(above - 1, 1)
                U = max(emax, kappa)
                u = U - kappa
                u_off = int(u > 0)
                emb = 0
                if u_off:
                    emb = sum(1 << n for n in range(4) if Es[n] == U)
                if c == 0:
                    mel.event(int(rho != 0))
                if c == 0 and rho == 0:
                    entry = None
                else:
                    opts = TABLES[0 if initial else 1][(c, rho, u_off)]
                    if u_off:
                        opts = [o for o in opts if emb & o[0] == o[1]]
                    else:
                        opts = [o for o in opts if o[0] == 0]
                    if pick is not None:
                        entry = pick(initial, c, rho, emb, opts)
                    else:
                        entry = max(opts, key=lambda o: (_popcount(o[0]),
                                                         -o[3]))
                    e_k, e_1, cwd, n_bits, idx = entry
                    vlc.extend((cwd >> j) & 1 for j in range(n_bits))
                    if used is not None:
                        used.add((0 if initial else 1, idx))
                e_k = entry[0] if entry else 0
                info.append((c0, rho, U, u, u_off, e_k))
                if initial:
                    c_prev = (rho & 1 | (rho >> 1) & 1) | ((rho >> 2) & 1) \
                        << 1 | ((rho >> 3) & 1) << 2
                else:
                    c_prev = int(rho & 0xC != 0)
            # U-VLC of the pair
            q0, q1 = info
            uo0 = q0[4]
            uo1 = q1[4] if q1 else 0
            u0 = q0[3]
            u1 = q1[3] if q1 else 0
            if used is not None:
                for uo, uu in ((uo0, u0), (uo1, u1)):
                    if uo:
                        used.add(("u", initial, uu))
            if uo0 and uo1:
                if initial:
                    both = u0 > 2 and u1 > 2
                    mel.event(int(both))
                    if used is not None:
                        used.add(("pair", "both>2" if both else "first>2"
                                  if u0 > 2 else "first<=2"))
                    if both:
                        p0, s0, n0 = uvlc_bits(u0 - 2)
                        p1, s1, n1 = uvlc_bits(u1 - 2)
                        vlc.extend(p0 + p1)
                        vlc.extend((s0 >> j) & 1 for j in range(n0))
                        vlc.extend((s1 >> j) & 1 for j in range(n1))
                    elif u0 > 2:
                        p0, s0, n0 = uvlc_bits(u0)
                        vlc.extend(p0)
                        vlc.append(u1 - 1)
                        vlc.extend((s0 >> j) & 1 for j in range(n0))
                    else:
                        p0, s0, n0 = uvlc_bits(u0)
                        p1, s1, n1 = uvlc_bits(u1)
                        vlc.extend(p0 + p1)
                        vlc.extend((s0 >> j) & 1 for j in range(n0))
                        vlc.extend((s1 >> j) & 1 for j in range(n1))
                else:
                    p0, s0, n0 = uvlc_bits(u0)
                    p1, s1, n1 = uvlc_bits(u1)
                    vlc.extend(p0 + p1)
                    vlc.extend((s0 >> j) & 1 for j in range(n0))
                    vlc.extend((s1 >> j) & 1 for j in range(n1))
            elif uo0 or uo1:
                uu = u0 if uo0 else u1
                p0, s0, n0 = uvlc_bits(uu)
                vlc.extend(p0)
                vlc.extend((s0 >> j) & 1 for j in range(n0))
            # MagSgn of the pair
            for qi in info:
                if qi is None:
                    continue
                c0, rho, U, u, u_off, e_k = qi
                for n in range(4):
                    if not rho >> n & 1:
                        continue
                    yy, xx = y0 + (n & 1), c0 + (n >> 1)
                    m = U - (e_k >> n & 1)
                    vv = int(v[yy, xx])
                    if vv >> m > 1:
                        raise AssertionError("MagSgn overflow")
                    ms.extend((vv >> j) & 1 for j in range(m))
    magsgn = pack_forward(ms, 1)
    melb = mel.finish()
    if used is not None:
        used.update(("mel", k) for k in mel.states)
    vlcb = bytearray(pack_backward(vlc, True))
    vlcb.append(0)                    # Scup's high byte
    scup = len(melb) + len(vlcb)
    if scup > 4079:
        raise ValueError(f"Scup {scup} above 4079")
    vlcb[-1] = scup >> 4
    vlcb[-2] = (vlcb[-2] & 0xF0) | (scup & 0xF)
    return magsgn + melb + bytes(vlcb)


def refinement_segment(q, plane, passes, causal=False):
    """The bytes of SigProp and (with 3 passes) MagRef of plane - 1: the
    refinement segment is SigProp's, read forward, then MagRef's, read
    backward from the segment's end."""
    h, w = q.shape
    mag = np.abs(q).astype(np.int64)
    sig = (mag >> plane) > 0
    bit = (mag >> (plane - 1)) & 1
    neg = q < 0
    new = np.zeros((h, w), bool)
    sp_bits, mr_bits = [], []

    def member(i, j, s):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if not di and not dj:
                    continue
                y, x = i + di, j + dj
                if not (0 <= y < h and 0 <= x < w):
                    continue
                if new[y, x]:
                    return True
                if sig[y, x] and not (causal and y >= 4 * s + 4):
                    return True
        return False

    for s in range((h + 3) // 4):
        rows = range(4 * s, min(4 * s + 4, h))
        for g in range(0, w, 4):
            fresh = []
            for j in range(g, min(g + 4, w)):
                for i in rows:
                    if sig[i, j] or not member(i, j, s):
                        continue
                    sp_bits.append(int(bit[i, j]))
                    if bit[i, j]:
                        new[i, j] = True
                        fresh.append((i, j))
            sp_bits.extend(int(neg[i, j]) for i, j in fresh)
        if passes > 2:
            for j in range(w):
                for i in rows:
                    if sig[i, j]:
                        mr_bits.append(int(bit[i, j]))
    return (pack_forward(sp_bits, 0),
            pack_backward(mr_bits, False) if passes > 2 else b"")


# ---------------------------------------------------------------------------
# wavelets, quantisation and colour
# ---------------------------------------------------------------------------

def fdwt53_1d(x, cas, axis):
    """The forward reversible 5/3 whose inverse is jpeg2000._idwt53_1d
    (first sample at an even (cas 0) or odd (cas 1) coordinate)."""
    x = np.moveaxis(x, axis, 0).copy()
    n = x.shape[0]
    if n == 1:
        if cas:
            x = x * 2
        return np.moveaxis(x, 0, axis)
    i = np.arange(n)
    lo, hi = i[cas::2], i[1 - cas::2]
    mir = j2k._mirror
    x[hi] -= (x[mir(hi - 1, n)] + x[mir(hi + 1, n)]) >> 1
    x[lo] += (x[mir(lo - 1, n)] + x[mir(lo + 1, n)] + 2) >> 2
    return np.moveaxis(x, 0, axis)


_A, _B, _C, _D = -1.586134342, -0.052980118, 0.882911075, 0.443506852
_K = 1.230174105


def fdwt97_1d(x, cas, axis):
    """A forward 9/7 in float64 whose inverse is jpeg2000._idwt97_1d."""
    x = np.moveaxis(x, axis, 0).astype(np.float64).copy()
    n = x.shape[0]
    sn = (n + 1 - cas) // 2
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (
            cas == 1 and not (sn > 0 or dn > 1)):
        return np.moveaxis(x, 0, axis)
    i = np.arange(n)
    lo, hi = i[cas::2], i[1 - cas::2]
    mir = j2k._mirror
    for t, c in ((hi, _A), (lo, _B), (hi, _C), (lo, _D)):
        x[t] = x[t] + (x[mir(t - 1, n)] + x[mir(t + 1, n)]) * c
    x[lo] /= _K
    x[hi] /= 2.0 / _K
    return np.moveaxis(x, 0, axis)


def forward_dwt(a, res, reversible):
    """The bands of a tile-component array over resolutions `res` (from
    jpeg2000._tile_component): [r] -> [band arrays], LL first."""
    fwd = fdwt53_1d if reversible else fdwt97_1d
    out = [None] * len(res)
    for r in range(len(res) - 1, 0, -1):
        rr = res[r]
        cx, cy = rr["x0"] & 1, rr["y0"] & 1
        if a.size:
            a = fwd(fwd(a, cy, 0), cx, 1)
        out[r] = (a[cy::2, 1 - cx::2], a[1 - cy::2, cx::2],
                  a[1 - cy::2, 1 - cx::2])
        a = a[cy::2, cx::2]
    out[0] = (a,)
    return out


def forward_rct(r, g, b):
    y = (r + 2 * g + b) >> 2
    return y, b - g, r - g


def forward_ict(r, g, b):
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.16875 * r - 0.33126 * g + 0.5 * b
    v = 0.5 * r - 0.41869 * g - 0.08131 * b
    return y, u, v


# ---------------------------------------------------------------------------
# code streams
# ---------------------------------------------------------------------------

class Comp:
    """A component's coding: levels, code-block size exponents, style bits
    besides 0x40 (0x08: the vertically causal context), precinct
    exponents per resolution (None: maximal)."""

    def __init__(self, levels=5, xcb=6, ycb=6, style=0, prec=None):
        self.levels, self.xcb, self.ycb = levels, xcb, ycb
        self.style, self.prec = style, prec

    def cod_body(self, reversible):
        body = bytes([self.levels, self.xcb - 2, self.ycb - 2,
                      0x40 | self.style, 1 if reversible else 0])
        if self.prec:
            body += bytes((py << 4) | px for px, py in self.prec)
        return body

    def coding(self, reversible):
        c = j2k._Coding.__new__(j2k._Coding)
        c.levels, c.style, c.wavelet = self.levels, 0x40 | self.style, \
            1 if reversible else 0
        c.xcb, c.ycb = self.xcb, self.ycb
        c.prec = list(self.prec) if self.prec else [(15, 15)] * (
            self.levels + 1)
        return c


def cap_marker(ccap=0x0000):
    """CAP (T.814 A.3): Pcap with Part 15's bit, and its Ccap15."""
    return struct.pack(">HHIH", 0xFF50, 8, 1 << (32 - 15), ccap)


def cpf_marker(words=(0x4000,)):
    """CPF (T.814 A.4): Lcpf and the Pcpf words."""
    return struct.pack(">HH", 0xFF59, 2 + 2 * len(words)) + b"".join(
        struct.pack(">H", x) for x in words)


def _steps(comp, reversible, bits, base_step):
    """(exponent, mantissa) per band in OpenJPEG's order: for the 5/3 the
    dynamic range (bits + the band's gain); for the 9/7 a step of
    base_step * 2^(level) per band, as exponent and mantissa."""
    out = []
    for b in range(3 * comp.levels + 1):
        gain = 0 if b == 0 else (1, 1, 2)[(b - 1) % 3]
        if reversible:
            out.append((bits + gain, 0))
        else:
            level = comp.levels if b == 0 else comp.levels - (b - 1) // 3
            step = base_step / (2.0 ** (level * 0.5)) * (1.5 if gain == 2
                                                         else 1.0)
            # step = (1 + m / 2048) * 2^(bits - e)
            e = bits - int(np.floor(np.log2(step)))
            m = int(round((step / 2.0 ** (bits - e) - 1.0) * 2048))
            m = min(max(m, 0), 2047)
            out.append((e, m))
    return out


def _qcd_body(steps, guard, reversible):
    if reversible:
        return bytes([guard << 5]) + bytes(e << 3 for e, _ in steps)
    return bytes([(guard << 5) | 2]) + b"".join(
        struct.pack(">H", (e << 11) | m) for e, m in steps)


class BlockPlan:
    """How a code-block is coded: cleanup plane P, passes and the layer
    each pass goes in."""

    def __init__(self, plane, passes, layers):
        self.plane, self.passes, self.layers = plane, passes, layers


def encode(comps_px, bits=8, comps=None, reversible=True, mct=False,
           tiles=None, layers=1, prog=LRCP, base_step=1.0, plan=None,
           cap=True, cpf=False, rsiz=True, jp2=False, brand=b"jp2 ",
           pick=None, used=None, block_hook=None, opj_layers=False):
    """An HTJ2K code stream (or JP2 file) of integer component planes
    comps_px ([h, w] each, unsigned `bits`): one tile, or tiles of
    `tiles` (width, height); the 5/3 (lossless where every block's
    cleanup goes down to plane 0) or the 9/7 with step sizes of
    `base_step` (expounded), the RCT or ICT over the first three
    components where `mct`; `layers` quality layers in progression
    `prog`; CAP, CPF and the Rsiz bit where asked; JP2 boxes of `brand`
    where `jp2`.

    comps: a Comp per component (COD from the first, COC where another
    differs); plan(c, r, band, block, q, Mb) -> BlockPlan (default: the
    whole block in the cleanup pass, in layer 0); block_hook(c, band
    orient, q, plan, segs) may replace a block's bytes, one entry a pass
    (cleanup, SigProp, MagRef, then empty placeholders); pick and used
    go to cleanup_segment; opj_layers: a later packet's passes written
    as OpenJPEG's tier-2 reads them (_packets)."""
    nc = len(comps_px)
    h, w = comps_px[0].shape
    comps = comps or [Comp()] * nc
    if len(comps) == 1 and nc > 1:
        comps = comps * nc
    XT, YT = tiles or (w, h)
    ntx, nty = j2k._ceildiv(w, XT), j2k._ceildiv(h, YT)
    px = [np.asarray(a, np.int64) - (1 << (bits - 1)) for a in comps_px]
    if mct:
        if reversible:
            px[:3] = forward_rct(*px[:3])
        else:
            px[:3] = forward_ict(*[a.astype(np.float64) for a in px[:3]])
    steps = [_steps(cm, reversible, bits, base_step) for cm in comps]
    tile_bytes = []
    for t in range(ntx * nty):
        p, qq = t % ntx, t // ntx
        tx0, ty0 = p * XT, qq * YT
        tx1, ty1 = min(tx0 + XT, w), min(ty0 + YT, h)
        tcomps = [j2k._tile_component(tx0, ty0, tx1, ty1,
                                      cm.coding(reversible)) for cm in comps]
        # by block: (its bytes a pass, or None for an empty block; plan)
        coded = {}
        for c, res in enumerate(tcomps):
            a = px[c][ty0:ty1, tx0:tx1]
            bands = forward_dwt(a, res, reversible)
            for r, rr in enumerate(res):
                for band, arr in zip(rr["bands"], bands[r]):
                    e, m = steps[c][band.index]
                    Mb = GUARD + e - 1
                    if reversible:
                        qarr = np.asarray(arr, np.int64)
                    else:
                        step = (1.0 + m / 2048.0) * 2.0 ** (bits - e)
                        qarr = (np.sign(arr) * np.floor(np.abs(arr) / step)
                                ).astype(np.int64)
                    band.q, band.Mb = qarr, Mb
            for r, rr in enumerate(res):
                for prc in rr["precincts"]:
                    for band, blocks, cw, ch, incl, zbp in prc:
                        for b in blocks:
                            qb = band.q[b.y0 - band.y0:b.y1 - band.y0,
                                        b.x0 - band.x0:b.x1 - band.x0]
                            top = _bitlen(np.abs(qb).max()) if qb.size else 0
                            if top > band.Mb:
                                raise ValueError(
                                    f"{top} planes above Mb {band.Mb}")
                            pl = plan(c, r, band, b, qb, band.Mb) if plan \
                                else BlockPlan(0, 1, [0])
                            if not top:
                                coded[id(b)] = (None, pl)
                                continue
                            causal = bool(comps[c].style & 0x08)
                            cu = cleanup_segment(qb, pl.plane, causal, pick,
                                                 used)
                            sp, mr = refinement_segment(
                                qb, pl.plane, min(pl.passes, 3), causal) \
                                if pl.passes > 1 else (b"", b"")
                            # passes past the third: empty placeholders
                            segs = (cu, sp, mr)[:pl.passes] + \
                                (b"",) * max(pl.passes - 3, 0)
                            if block_hook is not None:
                                segs = block_hook(c, band.orient, qb, pl,
                                                  segs)
                            coded[id(b)] = (segs, pl)
        order = j2k._packet_order(prog, layers, tcomps, tx0, ty0)
        tile_bytes.append(_packets(order, tcomps, coded, opj_layers))
    return _codestream(w, h, nc, bits, comps, reversible, mct, layers, prog,
                       steps, tile_bytes, cap, cpf, rsiz, jp2, brand, XT, YT)


def _packets(order, tcomps, coded, opj_layers=False):
    """Every packet of a tile in order: HT packet headers, then the
    bodies. A block's segments: the cleanup pass alone, then its SigProp
    and MagRef together (the bytes of each pass in the layer of that
    pass); each length on Lblock + floor(log2(the segment's passes in
    this packet)) bits."""
    out = []
    state = {}                        # id(block) -> [included, Lblock]
    for l, r, c, k in order:
        prc = tcomps[c][r]["precincts"][k]
        live = [coded[id(b)] for _, blocks, *_ in prc for b in blocks]
        if not any(segs and l in pl.layers for segs, pl in live):
            out.append(b"\0")
            continue
        bw = j2k._BitWriter()
        bw.put(1)
        body = []
        for band, blocks, cw, ch, incl, zbp in prc:
            if not blocks:
                continue
            if not getattr(incl, "primed", False):
                firsts, zeros = [], []
                for b in blocks:
                    segs, pl = coded[id(b)]
                    firsts.append(min(pl.layers) if segs else 1 << 20)
                    zeros.append(band.Mb - 1 - pl.plane if segs else 0)
                incl.set(firsts)
                zbp.set(zeros)
                incl.primed = True
            for leaf, b in enumerate(blocks):
                segs, pl = coded[id(b)]
                st = state.setdefault(id(b), [False, 3])
                take = [i for i, lay in enumerate(pl.layers) if lay == l] \
                    if segs else []
                if not st[0]:
                    incl.encode(bw, leaf, l + 1)
                    if not take:
                        continue
                    zbp.encode(bw, leaf, 1 << 20)
                    st[0] = True
                else:
                    bw.put(1 if take else 0)
                    if not take:
                        continue
                j2k._put_passes(bw, len(take))
                parts = []
                if take[0] == 0:
                    parts.append((1, segs[0]))
                elif opj_layers and take[0] == 1:
                    # as OpenJPEG reads it: the first pass of a later
                    # packet lengthens the cleanup's segment
                    parts.append((1, b""))
                    take = take[1:]
                rest = [i for i in take if i > 0]
                if rest:
                    parts.append((len(rest), b"".join(segs[i] for i in rest)))
                need = max(_bitlen(len(d)) - (_bitlen(n) - 1)
                           for n, d in parts) - st[1]
                for _ in range(max(need, 0)):
                    bw.put(1)
                bw.put(0)
                st[1] += max(need, 0)
                for n, d in parts:
                    bw.bits(len(d), st[1] + _bitlen(n) - 1)
                    body.append(d)
        out.append(bw.flush() + b"".join(body))
    return b"".join(out)


def _codestream(w, h, nc, bits, comps, reversible, mct, layers, prog,
                steps, tile_bytes, cap, cpf, rsiz, jp2, brand, XT, YT):
    siz = struct.pack(">HH8IH", 38 + 3 * nc, 0x4000 if rsiz else 0, w, h,
                      0, 0, XT, YT, 0, 0, nc) + bytes([bits - 1, 1, 1]) * nc
    main = b"\xff\x4f\xff\x51" + siz
    if cap:
        main += cap_marker()
    c0 = comps[0]
    scod = 1 if c0.prec else 0
    cod = bytes([scod, prog]) + struct.pack(">H", layers) \
        + bytes([1 if mct else 0]) + c0.cod_body(reversible)
    main += struct.pack(">HH", 0xFF52, 2 + len(cod)) + cod
    for c in range(1, nc):
        cm = comps[c]
        if vars(cm) != vars(c0):
            body = bytes([c, 1 if cm.prec else 0]) + cm.cod_body(reversible)
            main += struct.pack(">HH", 0xFF53, 2 + len(body)) + body
    q0 = _qcd_body(steps[0], GUARD, reversible)
    main += struct.pack(">HH", 0xFF5C, 2 + len(q0)) + q0
    for c in range(1, nc):
        qc = _qcd_body(steps[c], GUARD, reversible)
        if qc != q0:
            body = bytes([c]) + qc
            main += struct.pack(">HH", 0xFF5D, 2 + len(body)) + body
    if cpf:
        main += cpf_marker()
    out = main
    for t, data in enumerate(tile_bytes):
        sot = struct.pack(">HHHIBB", 0xFF90, 10, t, 12 + 2 + len(data), 0, 1)
        out += sot + b"\xff\x93" + data
    out += b"\xff\xd9"
    if not jp2:
        return out
    space = 16 if nc >= 3 else 17
    ihdr = j2k._box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bits - 1, 7,
                                         0, 0))
    colr = j2k._box(b"colr", struct.pack(">BBBI", 1, 0, 0, space))
    return (j2k.JP2_SIGNATURE + j2k._box(b"ftyp", brand + b"\0\0\0\0"
                                         + brand)
            + j2k._box(b"jp2h", ihdr + colr) + j2k._box(b"jp2c", out))
