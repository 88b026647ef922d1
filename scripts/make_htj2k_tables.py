"""Write ignis_tpu_torch/utils/htj2k_tables.py: the two CxtVLC code
tables of HTJ2K's cleanup pass (ITU-T T.814 Annex C, the tables for the
initial quad row and for the rest), as OpenJPEG holds them.

OpenJPEG keeps each table as 1,024 16-bit decoder entries, indexed by
(context << 7) | the next 7 bits of the VLC stream, each entry
(e_k << 12) | (e_1 << 8) | (rho << 4) | (u_off << 3) | codeword length.
The script finds the two tables in a libopenjp2 binary by that
structure alone (in each of the 8 contexts, every entry of length L
repeats at every index that agrees in the low L bits, and the lengths
are 1 to 7), checks that the copy beside it in OpenCV's cv2 module is
byte for byte the same, and writes each table as T.814 prints it: one
(context, codeword, length, rho, u_off, e_k, e_1) a codeword. Run from
the repository's root, with no argument (Pillow's bundled libopenjp2)
or the path of a libopenjp2:

    python scripts/make_htj2k_tables.py [libopenjp2.so]

Whether every entry is right is shown by OpenCV itself:
scripts/make_htj2k_fixtures.py writes `ht_vlc_all.j2k`, which uses each
codeword of both tables, and cv2 decodes it to its source exactly."""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "ignis_tpu_torch" / "utils" / "htj2k_tables.py"


def _is_table(t):
    if ((t & 7) == 0).any():
        return False
    j = np.arange(128)
    for c in range(8):
        blk = t[c * 128:(c + 1) * 128]
        for i in range(128):
            m = (1 << int(blk[i] & 7)) - 1
            if (blk[(j & m) == (i & m)] != blk[i]).any():
                return False
    return True


def find_tables(raw: bytes):
    """The byte offset of two adjacent 1,024-entry tables in raw."""
    words = np.frombuffer(raw[:len(raw) // 2 * 2], np.uint16)
    bad = np.concatenate([[0], np.cumsum((words & 7) == 0)])
    starts = np.nonzero(bad[2048:] - bad[:-2048] == 0)[0]
    for s in starts:
        if _is_table(words[s:s + 1024]) and \
                _is_table(words[s + 1024:s + 2048]):
            return 2 * int(s)
    raise SystemExit("no pair of CxtVLC tables found")


def entries(t):
    out = set()
    for i, v in enumerate(t.tolist()):
        n = v & 7
        out.add((i >> 7, (i & 0x7F) & ((1 << n) - 1), n, (v >> 4) & 15,
                 (v >> 3) & 1, v >> 12, (v >> 8) & 15))
    return sorted(out)


def main():
    if len(sys.argv) > 1:
        lib = Path(sys.argv[1])
    else:
        import PIL
        lib = sorted((Path(PIL.__file__).parent.parent / "pillow.libs")
                     .glob("libopenjp2-*.so*"))[0]
    raw = lib.read_bytes()
    at = find_tables(raw)
    t0 = np.frombuffer(raw[at:at + 2048], np.uint16)
    t1 = np.frombuffer(raw[at + 2048:at + 4096], np.uint16)
    try:
        import cv2
        mod = Path(cv2.__file__).parent
        blob = b"".join(p.read_bytes() for p in sorted(mod.glob("cv2*.so")))
        if blob.find(t0.tobytes()) < 0 or blob.find(t1.tobytes()) < 0:
            raise SystemExit("cv2's OpenJPEG holds other tables")
    except ImportError:
        pass
    lines = [
        '"""The CxtVLC code tables of HTJ2K\'s cleanup pass (ITU-T T.814',
        'Annex C): VLC0 for the initial quad row, VLC1 for the rest. Each',
        'entry is (context c_q, codeword (its first bit the least',
        'significant), codeword length, rho, u_off, e_k, e_1).',
        '',
        'Written by scripts/make_htj2k_tables.py from',
        f'{lib.name}; do not edit."""',
        '']
    for name, t in (("VLC0", t0), ("VLC1", t1)):
        lines.append(f"{name} = (")
        for e in entries(t):
            lines.append("    (%d, 0x%02X, %d, 0x%X, %d, 0x%X, 0x%X)," % e)
        lines.append(")")
        lines.append("")
    OUT.write_text("\n".join(lines))
    print(f"{lib.name}: tables at 0x{at:x}; {len(entries(t0))} + "
          f"{len(entries(t1))} codewords -> {OUT.relative_to(ROOT)}")


if __name__ == "__main__":
    main()
