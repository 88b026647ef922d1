"""AV1's forward transforms and quantiser, the encoder's side of
av1_recon.inverse_transform and the dequantisation of av1_recon.residuals.

The 2D forward transform runs as libaom's av1_fwd_txfm2d does: the input
shifted up by the size's first stage shift, the columns (vertical
kernel), a rounding shift, the rows (horizontal kernel), a rounding
shift, and for 2:1 rectangles a scaling by sqrt(2); outputs past 32 of a
64-point transform are zero. Its 1D kernels are the exact inverses of the
specification's, as real matrices: each is read off the normative
inverse (av1_recon's DCT 4-64, ADST 4/8/16 and identity 4-32 applied to
unit impulses) and inverted, so that a forward transform followed by the
decoder's inverse gives the residual back to within the rounding of the
stage shifts (the DCT and the 8- and 16-point ADST are orthogonal; the
4-point ADST is not quite). Flipped ADST kernels read their input
reversed.

The quantiser divides by the quantiser of the coefficient's position (the
plane's DC or AC step of `qindex` with its delta, weighted by the
quantiser matrix of `qm`), scaled up by the dequantiser's shift of large
transforms, and rounds with the given offset.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T
from .av1 import TX_ADJ, TXH, TXLH, TXLW, TXW
from .av1_recon import (_ADST, _FLIP, QM_OFFSET, ROW_SHIFT, TX_KINDS, _Clamp,
                        _one_d, qm_table)

# libaom's forward stage shifts (input, after the columns, after the rows)
FWD_SHIFT = {(4, 4): (2, 0, 0), (8, 8): (2, -1, 0), (16, 16): (2, -2, 0),
             (32, 32): (2, -4, 0), (64, 64): (0, -2, -2), (4, 8): (2, -1, 0),
             (8, 4): (2, -1, 0), (8, 16): (2, -2, 0), (16, 8): (2, -2, 0),
             (16, 32): (2, -4, 0), (32, 16): (2, -4, 0), (32, 64): (0, -2, -2),
             (64, 32): (2, -4, -2), (4, 16): (2, -1, 0), (16, 4): (2, -1, 0),
             (8, 32): (2, -2, 0), (32, 8): (2, -2, 0), (16, 64): (0, -2, 0),
             (64, 16): (2, -4, 0)}
_KERNELS = {}
_INVERSES = {}
_QUANTIZERS = {}


def inverse_kernel(kind: int, n: int) -> np.ndarray:
    """The normative 1D inverse's matrix [n, n] (float64, output by
    input), read off its response to unit impulses."""
    key = (kind, n)
    m = _INVERSES.get(key)
    if m is None:
        scale = 1 << 16
        cols = [np.where(np.arange(n) == j, scale, 0).astype(np.int64)
                for j in range(n)]
        out = _one_d(kind, cols, _Clamp(48))
        m = np.stack(out, 0).astype(np.float64) / scale
        _INVERSES[key] = m
    return m


def kernel(kind: int, n: int) -> np.ndarray:
    """The forward 1D kernel [n, n] (float64) of a transform kind: n / 2
    times the inverse of the normative inverse's matrix."""
    key = (kind, n)
    k = _KERNELS.get(key)
    if k is None:
        if kind == _FLIP:
            k = kernel(_ADST, n)[:, ::-1].copy()
        else:
            k = (n / 2.0) * np.linalg.inv(inverse_kernel(kind, n))
        _KERNELS[key] = k
    return k


def _round_shift(x, s):
    """x * 2^s rounded to the nearest integer, halves up, as libaom's
    round_shift rounds."""
    if s >= 0:
        return x * (1 << s)
    return np.floor(x / (1 << -s) + 0.5)


def forward_transform(resid: np.ndarray, tx: int, txtype: int) -> np.ndarray:
    """Coefficients (int64 [B, h, w], zero past 32 rows and columns) of a
    batch of residual blocks `resid` [B, h, w] of one size and type."""
    h, w = TXH[tx], TXW[tx]
    vk, hk = TX_KINDS[txtype]
    s0, s1, s2 = FWD_SHIFT[(w, h)]
    x = resid.astype(np.float64) * (1 << s0)
    x = _round_shift(kernel(vk, h) @ x, s1)
    x = _round_shift(x @ kernel(hk, w).T, s2)
    if abs(TXLW[tx] - TXLH[tx]) == 1:
        x = np.floor(x * (5793 / 4096) + 0.5)
    out = x.astype(np.int64)
    out[:, 32:, :] = 0
    out[:, :, 32:] = 0
    return out


def inverse_estimate(coef: np.ndarray, tx: int, txtype: int) -> np.ndarray:
    """The inverse transform of dequantised coefficients [B, h, w] in
    floating point, rounded once: within a level or two of the normative
    integer inverse (av1_recon.inverse_transform), at a fraction of its
    cost. The encoder's search reconstructs with it; what it writes is
    reconstructed by the normative one."""
    h, w = TXH[tx], TXW[tx]
    vk, hk = TX_KINDS[txtype]
    x = coef.astype(np.float64)
    if abs(TXLW[tx] - TXLH[tx]) == 1:
        x = x * (2896 / 4096)
    x = x @ _inverse_for(hk, w).T
    x = x / (1 << ROW_SHIFT[tx])
    x = _inverse_for(vk, h) @ x
    return np.floor(x / 16 + 0.5).astype(np.int64)


def _inverse_for(kind, n):
    if kind == _FLIP:
        return inverse_kernel(_ADST, n)[::-1]
    return inverse_kernel(kind, n)


def coefficient_scale(tx: int) -> float:
    """The factor between a forward coefficient and its orthonormal
    value: distortion in the coefficients over its square is the pixels'."""
    return 8.0 / (1 << ((TXW[tx] * TXH[tx] > 256) + (TXW[tx] * TXH[tx] >
                                                       1024)))


def quantizers(tx: int, plane: int, qindex: int, dq, qm_level: int,
               txtype: int, bd: int = 8) -> np.ndarray:
    """The dequantiser of each position [ah, aw] (int64, shared: not to be
    written) of a transform block, as the decoder applies it before its
    shift."""
    key = (tx, plane, qindex, dq[0], dq[1], qm_level, txtype < 9, bd)
    q = _QUANTIZERS.get(key)
    if q is None:
        q = _QUANTIZERS[key] = _quantizers(tx, plane, qindex, dq, qm_level,
                                           txtype, bd)
    return q


def _quantizers(tx, plane, qindex, dq, qm_level, txtype, bd):
    adj = TX_ADJ[tx]
    ah, aw = TXH[adj], TXW[adj]
    bi = (bd - 8) >> 1
    dcq = T.DC_Q[bi][max(0, min(255, qindex + dq[0]))]
    acq = T.AC_Q[bi][max(0, min(255, qindex + dq[1]))]
    q = np.full(ah * aw, acq, np.int64)
    q[0] = dcq
    if qm_level < 15 and txtype < 9:
        off = QM_OFFSET[adj]
        mat = qm_table()[qm_level, 1 if plane else 0, off:off + ah * aw]
        q = (q * mat.astype(np.int64) + 16) >> 5
    return q.reshape(ah, aw)


def quantize(coef: np.ndarray, tx: int, q: np.ndarray,
             rounding: float = 0.5) -> np.ndarray:
    """Signed levels [B, ah, aw] of forward coefficients `coef` [B, h, w]
    under the dequantisers `q` [ah, aw]: |c| * 2^shift / q, rounded down
    after adding `rounding`."""
    adj = TX_ADJ[tx]
    ah, aw = TXH[adj], TXW[adj]
    shift = (TXW[tx] * TXH[tx] > 256) + (TXW[tx] * TXH[tx] > 1024)
    c = coef[:, :ah, :aw]
    lev = np.floor(np.abs(c) * float(1 << shift) / q + rounding)
    return (np.sign(c) * lev).astype(np.int64)


def dequantize(levels: np.ndarray, tx: int, q: np.ndarray,
               bd: int = 8) -> np.ndarray:
    """What the decoder makes of `levels` [B, ah, aw] before its inverse
    transform: int64 [B, h, w]."""
    adj = TX_ADJ[tx]
    ah, aw = TXH[adj], TXW[adj]
    shift = (TXW[tx] * TXH[tx] > 256) + (TXW[tx] * TXH[tx] > 1024)
    lim = 1 << (7 + bd)
    v = ((np.abs(levels) * q) & 0xffffff) >> shift
    v = np.clip(np.sign(levels) * v, -lim, lim - 1)
    out = np.zeros((levels.shape[0], TXH[tx], TXW[tx]), np.int64)
    out[:, :ah, :aw] = v
    return out

