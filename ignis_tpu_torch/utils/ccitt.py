"""CCITT bilevel coding in numpy, as libtiff's tif_fax3.c decodes it for
OpenCV: Modified Huffman (TIFF compression 2, each row byte-aligned;
32771, each row aligned to 16 bits), T.4 (compression 3: EOL-led rows,
1-D, or 1-D and 2-D rows under Group3Options bit 0, zero fill before an
EOL) and T.6 (compression 4: 2-D rows against the row above, the first
against a white row). A row is a run of white, then black, then white,
... pixels; runs past 63 pixels take makeup codes (past 1,728 the
extended ones, shared by both colours, and past 2,560 several). Decoded
rows hold 1 for black and 0 for white, as libtiff fills them.
"""
from __future__ import annotations

import functools

import numpy as np

# ITU-T T.4 tables 2 and 3: (run length, code) of the terminating codes
# (0-63) and makeup codes (64-1728) of each colour; the extended makeup
# codes (1792-2560) are both colours'
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
_EXTENDED = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")
# T.4 table 4: the 2-D coding modes
MODES = {"P": "0001", "H": "001", "V0": "1", "VR1": "011", "VR2": "000011",
         "VR3": "0000011", "VL1": "010", "VL2": "000010", "VL3": "0000010"}
_PEEK = 13


def run_codes(black: bool) -> dict:
    """run length -> code ('0'/'1' string) of one colour: terminating,
    makeup and extended makeup codes."""
    codes = dict(enumerate((_BLACK if black else _WHITE).split()))
    makeup = (_BLACK_MAKEUP if black else _WHITE_MAKEUP).split()
    codes.update({64 * (k + 1): c for k, c in enumerate(makeup)})
    codes.update({1792 + 64 * k: c for k, c in enumerate(_EXTENDED.split())})
    return codes


def _lut(codes: dict) -> list:
    """A 2^13-entry lookup of a 13-bit peek: (code length, value); eleven
    zeros are libtiff's EOL entry (11, 'EOL'), and where no code starts,
    (0, None)."""
    lut = [(0, None)] * (1 << _PEEK)
    for k in range(1 << (_PEEK - 11)):
        lut[k] = (11, "EOL")
    for value, code in codes.items():
        lo = int(code, 2) << (_PEEK - len(code))
        for k in range(1 << (_PEEK - len(code))):
            lut[lo + k] = (len(code), value)
    return lut


@functools.cache
def _luts() -> dict:
    """The lookups of white and black runs and of the 2-D modes."""
    return {"white": _lut(run_codes(False)), "black": _lut(run_codes(True)),
            "mode": _lut(MODES)}


class _EndOfData(Exception):
    """libtiff's bit accumulator ran dry at the end of a chunk."""


class _Bits:
    """An MSB-first bit string of a chunk (FillOrder 2 reversed first),
    read through a model of libtiff's bit accumulator: before a code it
    holds at least the code table's width (12 bits for a white run, 13 for
    a black one, 7 for a 2-D mode), `loaded` a byte at a time; past the
    data's end it is padded with zeros to that width, and only when it is
    empty there does the chunk end (`_EndOfData`)."""

    def __init__(self, raw: bytes, reverse: bool):
        b = np.frombuffer(raw, np.uint8)
        bits = np.unpackbits(b, bitorder="little" if reverse else "big")
        self.s = "".join("01"[v] for v in bits.tolist()) + "0" * 32
        self.nbytes = len(raw)
        self.pos = self.loaded = self.avail = 0

    def need(self, width: int):
        for _ in range(2):
            if self.avail >= width:
                return
            if self.loaded == self.nbytes:
                if self.avail == 0:
                    raise _EndOfData
                self.avail = width
                return
            self.loaded += 1
            self.avail += 8

    def take(self, k: int):
        self.pos += k
        self.avail -= k

    def code(self, lut, width: int):
        """The value of the code at the position (None where none starts,
        'EOL' past eleven zeros), consumed."""
        self.need(width)
        size, value = lut[int(self.s[self.pos:self.pos + _PEEK], 2)]
        self.take(size)
        return value

    def run(self, black: bool):
        """One run: makeup codes, then a terminating code; None where a
        code is missing or an EOL comes first (libtiff ends the row)."""
        lut = _luts()["black" if black else "white"]
        total = 0
        while True:
            v = self.code(lut, 13 if black else 12)
            if v is None or v == "EOL":
                return None
            total += v
            if v < 64:
                return total

    def eol(self):
        """Skip to past the next EOL (eleven or more zeros, then a one)."""
        j = self.s.find("000000000001", self.pos)
        if j < 0 or j >= 8 * self.nbytes:
            raise _EndOfData
        self.pos = self.s.index("1", j) + 1
        self.loaded = max(self.loaded, -(-self.pos // 8))
        self.avail = self.loaded * 8 - self.pos

    def align(self, bits: int):
        """libtiff's row alignment of compression 2 (8 bits) and 32771
        (16): the accumulator's bits cut to a multiple of `bits`, and at
        16 an odd byte skipped where the accumulator is then empty (so a
        row can start 8 bits past a multiple of 16)."""
        self.take(self.avail % bits)
        if bits == 16 and self.avail == 0 and self.loaded & 1:
            self.loaded += 1
            self.pos += 8


def _cleanup(out: list, w: int) -> list:
    """libtiff's CLEANUP_RUNS of a row that ends short of its width or
    past it: changes past the width dropped, and the rest of the row
    white."""
    while out and out[-1] > w:
        out.pop()
    if len(out) & 1:
        out.append(out[-1])
    return out + [w]


def _row_1d(bits: _Bits, w: int) -> list:
    """The changing elements of a 1-D coded row."""
    out, x, black = [], 0, False
    while x < w:
        try:
            r = bits.run(black)
        except _EndOfData as e:
            e.row = _cleanup(out, w)
            raise
        if r is None:
            return _cleanup(out, w)
        x += r
        out.append(x)
        black = not black
    return out if x == w else _cleanup(out, w)


def _row_2d(bits: _Bits, w: int, ref: list) -> list:
    """The changing elements of a 2-D coded row against those of the row
    above (`ref`, ascending; even entries turn white to black)."""
    modes = _luts()["mode"]
    out, a0, black = [], -1, False
    ref = ref + [w, w, w]
    k = 0
    while a0 < w:
        # b1: the first change right of a0 to the colour opposite a0's
        while k > 0 and ref[k - 1] > a0:
            k -= 1
        while ref[k] <= a0 or (k & 1) != black:
            k += 1
        b1, b2 = ref[k], ref[k + 1]
        try:
            mode = bits.code(modes, 7)
        except _EndOfData as e:
            e.row = _cleanup(out, w)
            raise
        if mode is None or mode == "EOL":
            return _cleanup(out, w)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            r1 = bits.run(black)
            r2 = None if r1 is None else bits.run(not black)
            if r2 is None:
                return _cleanup(out, w)
            a1 = max(a0, 0) + r1
            a0 = a1 + r2
            out += [a1, a0]
            if a0 > w:
                return _cleanup(out, w)
        else:
            d = int(mode[2]) if len(mode) == 3 else 0
            a1 = b1 + (d if mode[1:2] == "R" else -d)
            if a1 < max(a0, 0) or a1 > w:
                raise IOError("CCITT: a vertical mode leaves the row")
            out.append(a1)
            a0 = a1
            black = not black
    return out


def _fill(changes: list, w: int) -> np.ndarray:
    """uint8 [w] row of 1 (black) and 0 (white) from changing elements."""
    row = np.zeros(w + 1, np.int8)
    edges = np.minimum(np.asarray(changes, np.int64), w)
    np.add.at(row, edges, np.where(np.arange(len(edges)) % 2 == 0, 1, -1))
    return (np.cumsum(row[:w]) > 0).astype(np.uint8)


def decode(raw: bytes, rows: int, w: int, comp: int, options: int = 0,
           fill_order: int = 1) -> np.ndarray:
    """[rows, w] uint8 (1 black, 0 white) of one strip or tile coded under
    TIFF compression 2, 32771, 3 (`options`: Group3Options, bit 0 for 2-D
    rows) or 4."""
    bits = _Bits(raw, fill_order == 2)
    out = np.zeros((rows, w), np.uint8)
    ref: list = []
    for y in range(rows):
        try:
            if comp in (2, 32771):
                if y:
                    bits.align(8 if comp == 2 else 16)
                cur = _row_1d(bits, w)
            elif comp == 3:
                bits.eol()
                two_d = False
                if options & 1:
                    bits.need(1)
                    two_d = bits.s[bits.pos] == "0"
                    bits.take(1)
                cur = _row_2d(bits, w, ref) if two_d else _row_1d(bits, w)
            else:
                cur = _row_2d(bits, w, ref)
        except _EndOfData as e:
            # libtiff fills the row it was in and fails the chunk; OpenCV
            # keeps the chunk's buffer, zeros past that row
            if hasattr(e, "row"):
                out[y] = _fill(e.row, w)
            break
        out[y] = _fill(cur, w)
        ref = cur
    return out
