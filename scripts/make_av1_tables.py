"""Write ignis_tpu_torch/utils/av1_tables.py: the AV1 decoder's constant
tables, taken byte for byte from a libaom 3.14.1 shared library.

The AV1 specification's default CDFs, quantiser lookups, quantiser
matrices and filter taps (superres's Upscale_Filter too) are libaom's
own arrays; this script reads them from the library's .rodata at the
offsets of opencv-python 5.0.0's wheel
(`opencv_python.libs/libaom-a0d22147.so.3.14.1`), checks each CDF's shape
(falling inverse values, a closing 0 and a zero counter), and writes them
in the specification's form. Nothing reads the library at run time.

    python scripts/make_av1_tables.py PATH/TO/libaom-a0d22147.so.3.14.1
"""
import base64
import sys
import zlib
from pathlib import Path

import numpy as np

OUT = (Path(__file__).resolve().parent.parent / "ignis_tpu_torch" / "utils"
       / "av1_tables.py")

# name -> (offset, dims, symbols per CDF (int or a function of the
# flat index), entries per CDF in memory)
CDFS = {
    "KF_Y_MODE": (0x65b9e0, (5, 5), 13, 14),
    "UV_MODE_CFL_NOT_ALLOWED": (0x65b6c0, (13,), 13, 15),
    "UV_MODE_CFL_ALLOWED": (0x65b846, (13,), 14, 15),
    "PARTITION": (0x65b500, (20,),
                  lambda i: 4 if i < 4 else 10 if i < 16 else 8, 11),
    "INTRA_TX_SET1": (0x65a728, (4, 13), 7, 17),
    "INTRA_TX_SET2": (0x65ae10, (4, 13), 5, 17),
    "INTER_TX_SET1": (0x659ea8, (4,), 16, 17),
    "INTER_TX_SET2": (0x659f30, (4,), 12, 17),
    "INTER_TX_SET3": (0x659fb8, (4,), 2, 17),
    "CFL_SIGN": (0x64c810, (), 8, 9),
    "CFL_ALPHA": (0x64c820, (6,), 16, 17),
    "ANGLE_DELTA": (0x64c020, (8,), 7, 8),
    "PALETTE_Y_SIZE": (0x64bf40, (7,), 7, 8),
    "PALETTE_UV_SIZE": (0x64bfb0, (7,), 7, 8),
    "PALETTE_Y_COLOR": (0x6598a0, (7, 5), lambda i: i // 5 + 2, 9),
    "PALETTE_UV_COLOR": (0x659620, (7, 5), lambda i: i // 5 + 2, 9),
    "PALETTE_Y_MODE": (0x64c110, (7, 3), 2, 3),
    "SKIP": (0x64c740, (3,), 2, 3),
    "SEGMENT_ID": (0x64c760, (3,), 8, 9),
    "TX_SIZE": (0x64c790, (4, 3), lambda i: 2 if i < 3 else 3, 4),
    "COEFF_BASE_EOB": (0x651740, (4, 5, 2, 4), 3, 4),
    "COEFF_BASE": (0x651c40, (4, 5, 2, 42), 4, 5),
    "COEFF_BR": (0x655de0, (4, 5, 2, 21), 4, 5),
    "EOB_PT_1024": (0x657ec0, (4, 2, 2), 11, 12),
    "EOB_PT_512": (0x658040, (4, 2, 2), 10, 11),
    "EOB_PT_256": (0x6581a0, (4, 2, 2), 9, 10),
    "EOB_PT_128": (0x6582e0, (4, 2, 2), 8, 9),
    "EOB_PT_64": (0x658400, (4, 2, 2), 7, 8),
    "EOB_PT_32": (0x658500, (4, 2, 2), 6, 7),
    "EOB_PT_16": (0x6585e0, (4, 2, 2), 5, 6),
    "EOB_EXTRA": (0x6586a0, (4, 5, 2, 9), 2, 3),
    "TXB_SKIP": (0x658f20, (4, 5, 13), 2, 3),
    "DC_SIGN": (0x659540, (4, 2, 3), 2, 3),
    "TXFM_SPLIT": (0x64c250, (21,), 2, 3),
    "MV_JOINT": (0x65bca0, (), 4, 5),
    "MV_CLASS": (0x65bcaa, (), 11, 12),
    "MV_SIGN": (0x65bce0, (), 2, 3),
    "MV_CLASS0_BIT": (0x65bcf2, (), 2, 3),
    "MV_BIT": (0x65bcf8, (10,), 2, 3),
    "MV_CLASS0_FP": (0x65bcc2, (2,), 4, 5),
    "MV_FP": (0x65bcd6, (), 4, 5),
    "MV_CLASS0_HP": (0x65bce6, (), 2, 3),
    "MV_HP": (0x65bcec, (), 2, 3),
    # inter frames
    "Y_MODE": (0x64c640, (4,), 13, 14),
    "COMP_MODE": (0x64c0a0, (5,), 2, 3),
    "COMP_REF_TYPE": (0x64c0c0, (5,), 2, 3),
    "SINGLE_REF": (0x64c1e0, (3, 6), 2, 3),
    "COMPOUND_MODE": (0x64c480, (8,), 8, 9),
    "INTERP_FILTER": (0x64c6b0, (16,), 3, 4),
    "WEDGE_INDEX": (0x659b20, (22,), 16, 17),
}

# Inter CDFs whose arrays the compiler split: runs of whole CDFs in
# .rodata (offset, count, entries per CDF in memory) and, between them,
# the CDFs it writes with immediates in code, given here by value (the
# specification's defaults, which are libaom's source). A run's last CDF
# may lack its closing 0 and counter, which code writes too.
SPLIT_CDFS = {
    "IS_INTER": ((4,), 2, [(0x64c750, 3, 3), [[26538]]]),
    "UNI_COMP_REF": ((3, 3), 2, [(0x64c0e0, 8, 3), [[26710]]]),
    "COMP_REF": ((3, 3), 2, [(0x64c190, 8, 3), [[27544]]]),
    "COMP_BWDREF": ((3, 2), 2, [(0x64c1c0, 6, 3)]),
    "COMPOUND_IDX": ((6,), 2, [(0x64c2d0, 6, 3)]),
    "COMP_GROUP_IDX": ((6,), 2, [(0x64c2f0, 6, 3)]),
    "NEW_MV": ((6,), 2, [(0x64c310, 6, 3)]),
    "ZERO_MV": ((2,), 2, [[[2175], [1054]]]),
    "REF_MV": ((6,), 2, [(0x64c330, 6, 3)]),
    "DRL_MODE": ((3,), 2, [(0x64c350, 3, 3)]),
    "MOTION_MODE": ((22,), 3, [(0x64c360, 16, 4), [[10923, 21845]] * 2,
                               (0x64c3e0, 4, 4)]),
    "USE_OBMC": ((22,), 2, [(0x64c400, 22, 3)]),
    "COMPOUND_TYPE": ((22,), 2, [[[16384]] * 3, (0x64c512, 19, 3)]),
    "INTERINTRA": ((4,), 2, [(0x64c580, 3, 3), [[30237]]]),
    "WEDGE_INTERINTRA": ((22,), 2, [[[16384]] * 3, (0x64c592, 8, 3),
                                    [[16384]] * 11]),
    "INTERINTRA_MODE": ((4,), 4, [(0x64c5c0, 3, 5),
                                  [[4238, 11537, 25926]]]),
    "SKIP_MODE": ((3,), 2, [(0x64c730, 3, 3)]),
    "SEGMENT_ID_PREDICTED": ((3,), 2, [[[16384]] * 3]),
}


def _valid(raw, count, nsym, stride):
    for i in range(count):
        n = nsym(i) if callable(nsym) else nsym
        blk = raw[i * stride:(i + 1) * stride]
        if not (np.all(np.diff(blk[:n - 1]) < 0) and blk[n - 2] > 0
                and blk[n - 1] == 0):
            return False
    return True


def cdf_table(lib, off, dims, nsym, stride):
    """An array of CDFs. Where the compiler stored the array as 16-byte
    chunks whose last one overlaps the one before (so that it ends at the
    array's end), the tail is read from that last chunk."""
    count = int(np.prod(dims)) if dims else 1
    total = count * stride
    raw = np.frombuffer(lib, "<u2", total, off).astype(np.int64)
    if not _valid(raw, count, nsym, stride):
        full = total // 8 * 8
        mem = np.frombuffer(lib, "<u2", full + 8, off).astype(np.int64)
        raw = np.concatenate([mem[:full], mem[full + 8 - (total - full):]])
    if not _valid(raw, count, nsym, stride) and not callable(nsym):
        # stored without the counters: N entries per CDF
        stride = nsym
        raw = np.frombuffer(lib, "<u2", count * stride, off).astype(np.int64)
    assert _valid(raw, count, nsym, stride), (hex(off), raw)
    out = []
    for i in range(count):
        n = nsym(i) if callable(nsym) else nsym
        out.append([int(32768 - v) for v in raw[i * stride:
                                                 i * stride + n - 1]])
    for d in reversed(dims[1:]):
        out = [out[k:k + d] for k in range(0, len(out), d)]
    return out if dims else out[0]


def split_cdf_table(lib, dims, nsym, pieces):
    """A CDF array from SPLIT_CDFS' runs and values, each run checked as
    CDFs (falling inverse values, the closing 0 where the run holds it)."""
    out = []
    for piece in pieces:
        if isinstance(piece, list):
            out += piece
            continue
        off, count, stride = piece
        raw = np.frombuffer(lib, "<u2", count * stride, off).astype(np.int64)
        for i in range(count):
            blk = raw[i * stride:i * stride + nsym]
            assert np.all(np.diff(blk[:nsym - 1]) < 0) and blk[nsym - 2] > 0
            assert i == count - 1 or blk[nsym - 1] == 0, (hex(off), i)
            out.append([int(32768 - v) for v in blk[:nsym - 1]])
    for d in reversed(dims[1:]):
        out = [out[k:k + d] for k in range(0, len(out), d)]
    assert len(out) == dims[0]
    return out


def ints(lib, off, dtype, n):
    return [int(v) for v in np.frombuffer(lib, dtype, n, off)]


def main(path):
    lib = Path(path).read_bytes()
    lines = ['"""The AV1 decoder\'s constant tables (written by',
             'scripts/make_av1_tables.py from libaom 3.14.1; do not edit).',
             '',
             'CDFs are in the specification\'s form: each a list of the',
             'cumulative frequencies of its first N - 1 symbols (of 32768).',
             'Quantiser matrices (QM, inverse weights, levels 0-14) are',
             'zlib-compressed and base64-encoded; `quantizer_matrix()` unpacks',
             'them as uint8 [15, 2, 3344]."""',
             "import base64", "import zlib", "", "import numpy as np", ""]
    for name, (off, dims, nsym, stride) in CDFS.items():
        lines.append(f"{name} = {cdf_table(lib, off, dims, nsym, stride)!r}")
    for name, (dims, nsym, pieces) in SPLIT_CDFS.items():
        lines.append(f"{name} = {split_cdf_table(lib, dims, nsym, pieces)!r}")
    # CDFs the compiler folded into immediates (the same values stand in
    # dav1d's default context)
    # (USE_FILTER_INTRA's runs of 16384 are stored by code, the rest at
    # 0x64c5e0)
    lines += ["PALETTE_UV_MODE = [[32461], [21488]]",
              "USE_FILTER_INTRA = [[4621], [6743], [5893], [7866], [12551],"
              " [9394], [12408], [14301], [12756], [22343]] + [[16384]] * 6"
              " + [[12770], [10368], [20229], [18101], [16384], [16384]]",
              "DELTA_Q = [28160, 32120, 32677]",
              "DELTA_LF = [28160, 32120, 32677]",
              "INTRABC = [30531]",
              "FILTER_INTRA_MODE = [8949, 12776, 17211, 29558]",
              "RESTORATION_TYPE = [9413, 22581]",
              "USE_WIENER = [11570]", "USE_SGRPROJ = [16855]"]
    q = {"DC_Q": (0x68daa0, 0x68d8a0, 0x68d6a0),
         "AC_Q": (0x68d4a0, 0x68d2a0, 0x68d0a0)}
    for name, offs in q.items():
        lines.append(f"{name} = {[ints(lib, o, '<i2', 256) for o in offs]!r}")
    sm = ints(lib, 0x64b3a0, "u1", 4 + 8 + 16 + 32 + 64)
    lines.append(f"SM_WEIGHTS = {{4: {sm[:4]}, 8: {sm[4:12]}, "
                 f"16: {sm[12:28]}, 32: {sm[28:60]}, 64: {sm[60:124]}}}")
    lines.append(f"DR_INTRA_DERIVATIVE = {ints(lib, 0x68e4a0, '<u2', 90)}")
    taps = np.frombuffer(lib, "i1", 5 * 8 * 8, 0x68e340).reshape(5, 8, 8)
    assert not taps[..., 7].any()
    lines.append(f"FILTER_INTRA_TAPS = {taps[..., :7].tolist()!r}")
    up = np.frombuffer(lib, "<i2", 64 * 8, 0x68e800).reshape(64, 8)
    assert (up.sum(1) == 128).all() and up[0, 3] == 128
    lines.append("# superres: Upscale_Filter, 64 phases of 8 taps")
    lines.append(f"UPSCALE_FILTER = {up.tolist()!r}")
    sgr = np.frombuffer(lib, "<i4", 64, 0x690680).reshape(16, 4)
    lines.append("# r0, s0, r1, s1 per set")
    lines.append(f"SGR_PARAMS = {sgr[:, [0, 2, 1, 3]].tolist()!r}")
    lines.append(f"X_BY_XPLUS1 = {ints(lib, 0x690280, '<i4', 256)}")
    lines.append(f"ONE_BY_X = {ints(lib, 0x690200, '<i4', 25)}")
    lines.append(f"COSPI = {ints(lib, 0x6510c0, '<i4', 64) + [0]}")
    lines.append(f"SINPI = {ints(lib, 0x650e88, '<i4', 5)}")
    lines.append("# inter prediction: Subpel_Filters (REGULAR, SMOOTH, SHARP,")
    lines.append("# BILINEAR, 4-tap REGULAR, 4-tap SMOOTH), 16 phases of 8 taps")
    sub = [np.frombuffer(lib, "<i2", 128, o).reshape(16, 8).tolist()
           for o in (0x690000, 0x68fe00, 0x68ff00, 0x690100, 0x69ce00,
                     0x69cd00)]
    assert all(sum(t) == 128 for f in sub for t in f)
    lines.append(f"SUBPEL_FILTERS = {sub!r}")
    warp = np.frombuffer(lib, "<i2", 193 * 8, 0x69bcc0).reshape(193, 8)
    assert (warp.sum(1) == 128).all()
    lines.append(f"WARPED_FILTERS = {warp.tolist()!r}")
    lines.append(f"DIV_LUT = {ints(lib, 0x69baa0, '<i2', 257)}")
    lines.append("# motion vector projection: 16384 / d for d = 0 .. 31")
    lines.append(f"DIV_MULT = {ints(lib, 0x65bfa0, '<i4', 32)}")
    obmc = {n: ints(lib, o, "u1", n) for n, o in (
        (1, 0x68de1e), (2, 0x68de1c), (4, 0x68de18), (8, 0x68de10),
        (16, 0x68de00), (32, 0x68dde0), (64, 0x68dda0))}
    lines.append(f"OBMC_MASK = {obmc!r}")
    qw = np.frombuffer(lib, "<i4", 8, 0x68e1e0).reshape(4, 2).tolist()
    ql = np.frombuffer(lib, "<i4", 8, 0x68e1c0).reshape(4, 2).tolist()
    lines.append(f"QUANT_DIST_WEIGHT = {qw!r}")
    lines.append(f"QUANT_DIST_LOOKUP = {ql!r}")
    # the specification's Wedge_Codebook order: h > w, h < w, h == w
    cb = [np.frombuffer(lib, "<i4", 48, o).reshape(16, 3).tolist()
          for o in (0x68e040, 0x68df80, 0x68dec0)]
    lines.append("# direction, x offset, y offset of each wedge")
    lines.append(f"WEDGE_CODEBOOK = {cb!r}")
    # Wedge_Master_Vertical: its leading zeros are cleared by code, the
    # rest stored from index 29
    vert = [0] * 29 + ints(lib, 0x64c8fd, "u1", 35)
    assert vert[28:36] == [0, 2, 7, 21, 43, 57, 62, 64] and \
        set(vert[35:]) == {64}
    # libaom's wedge_signflip_lookup, [block size][wedge] (its .data)
    flip = np.frombuffer(lib, "u1", 22 * 16, 0x74e4c0)
    lines.append(f"WEDGE_SIGNFLIP = {flip.reshape(22, 16).tolist()!r}")
    lines.append(f"WEDGE_MASTER_OBLIQUE_EVEN = {ints(lib, 0x68e100, 'u1', 64)}")
    lines.append(f"WEDGE_MASTER_OBLIQUE_ODD = {ints(lib, 0x68e140, 'u1', 64)}")
    lines.append(f"WEDGE_MASTER_VERTICAL = {vert}")
    lines.append(f"II_WEIGHTS_1D = {ints(lib, 0x68de40, 'u1', 128)}")
    lines.append("# film grain")
    lines.append(f"GAUSSIAN_SEQUENCE = {ints(lib, 0x69e500, '<i4', 2048)}")
    # libaom keeps a rectangular matrix column by column; the
    # specification's Quantizer_Matrix holds it row by row
    qm = np.frombuffer(lib, np.uint8, 15 * 2 * 3344, 0x65c0e0).reshape(
        15, 2, 3344).copy()
    for off, w, h in ((1360, 4, 8), (1392, 8, 4), (1424, 8, 16),
                      (1552, 16, 8), (1680, 16, 32), (2192, 32, 16),
                      (2704, 4, 16), (2768, 16, 4), (2832, 8, 32),
                      (3088, 32, 8)):
        blk = qm[:, :, off:off + w * h].reshape(15, 2, w, h)
        qm[:, :, off:off + w * h] = blk.transpose(0, 1, 3, 2).reshape(
            15, 2, w * h)
    qm = qm.tobytes()
    b64 = base64.b64encode(zlib.compress(qm, 9)).decode()
    lines.append("_QM = (")
    lines += [f'    "{b64[k:k + 72]}"' for k in range(0, len(b64), 72)]
    lines.append(")")
    lines += ["", "",
              "def quantizer_matrix() -> np.ndarray:",
              '    """Inverse quantiser weights, uint8 [level 0-14, luma or'
              ' chroma, 3344]."""',
              "    return np.frombuffer(zlib.decompress(base64.b64decode(_QM)),",
              "                         np.uint8).reshape(15, 2, 3344)", ""]
    text = "\n".join(lines)
    # keep lines short: break long list literals at commas
    out = []
    for line in text.split("\n"):
        while len(line) > 79:
            cut = line.rfind(", ", 0, 78)
            out.append(line[:cut + 1])
            line = "    " + line[cut + 2:]
        out.append(line)
    OUT.write_text("\n".join(out))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main(sys.argv[1])
