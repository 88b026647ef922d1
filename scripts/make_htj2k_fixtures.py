"""Write the HTJ2K fixtures (ITU-T T.814, JPEG 2000 Part 15): files of
the hand-written HT encoder in scripts/htj2k_encoder.py, each judged by
OpenCV (cv2 5.0.0, OpenJPEG 2.5.3), through which ignis_tpu reads
textures, and by Pillow's libopenjp2 2.5.4 as a second opinion.

Before anything is written: cv2 decodes every file of FIXTURES (and
Pillow reads each to the same samples), each lossless one exactly to its
seeded source, so that the encoder's code tables and stream rules are
proved by cv2 alone; cv2 and Pillow read nothing of each file of
UNREAD_FIXTURES; and `ht_vlc_all` uses every codeword of both CxtVLC
tables and each initial-row pair rule, and U-VLC values 1 to 15 in
both kinds of quad row; `ht_grey16` reaches u = 16 and 17, 17 the most
a 16-bit component needs; `ht_sparse` passes through every MEL state.
Run from the repository's root:

    python scripts/make_htj2k_fixtures.py

Into tests/data/images, each also added to `cv2_pixels.npz` as
cv2.imread reads it (IMREAD_UNCHANGED | ANYDEPTH | ANYCOLOR, grey
replicated; the other entries stay as they are):
- `ht_grey8_53.j2k`: a raw code stream, 8-bit grey, the 5/3, lossless,
  the cleanup pass only, 64 x 64 code-blocks;
- `ht_rgb8_rct.jp2`: RGB through the RCT in JP2 boxes, lossless;
- `ht_rgb8_97.jp2`: the 9/7 and the ICT, quantised with expounded step
  sizes, the cleanup pass only;
- `ht_sigprop.j2k`: two passes (cleanup and SigProp) in one layer;
- `ht_magref.j2k`: three passes, the cleanup in layer 0 and SigProp and
  MagRef in layer 1, under termination on each pass (code-block style
  0x44), as T.814 writes them; `ht_layers_opj.j2k`: the same split
  without it, written as OpenJPEG reads such packets (a later packet's
  first pass lengthens the cleanup's segment, here by no bytes);
- `ht_grey16.j2k`: 16-bit grey, lossless, with the largest magnitudes a
  16-bit component's 5/3 gives (U-VLC's longest codes, u up to 17);
- `ht_odd_tiles.jp2`: 71 x 53 pixels, 2 x 2 tiles, 32 x 32 code-blocks
  and precincts in RPCL order for two components, 16 x 128 code-blocks
  (COC) for the third, lossless;
- `ht_sparse.j2k`: a flat image with a few spots: empty code-blocks,
  all-zero bands and MEL runs through every MEL state, lossless;
- `ht_vlc_all.j2k`: the table walker: 16-bit grey without a wavelet,
  64 x 4 code-blocks, each quad's codeword chosen among those that fit it
  so that every codeword of both tables is used, lossless;
- `ht_texture_64.jp2`: the 64 x 64 texture of chip_smoke.py's phase 16:
  three passes over two layers, 2 x 2 tiles, CAP and CPF;
- `ht_rgb8.jph`: lossless RGB in JP2 boxes of the JPH brand (`jph `);
- `ht_empty_refinement.j2k`: two passes with an empty refinement
  segment in some code-blocks (decoded from the cleanup pass alone).

Into tests/data/images_unread, the HT files cv2 reads nothing of:
`ht_4passes.j2k` (more than three passes in a code-block),
`ht_rgn.j2k` (an RGN shift), `ht_mixed.j2k` (code-block style 0xC0,
mixed mode), `ht_scup.j2k` (a Scup past its cleanup segment),
`ht_layers_t814.j2k` (ht_layers_opj's split as T.814 writes it, which
OpenJPEG's tier-2 misreads) and `ht_empty_cleanup.j2k` (a code-block
whose cleanup segment has no bytes). A rerun writes the same bytes."""
import io
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))
import htj2k_encoder as H  # noqa: E402
from ignis_tpu_torch.utils.htj2k_tables import VLC0, VLC1  # noqa: E402

DATA = HERE.parent / "tests" / "data"
OUT = DATA / "images"
UNREAD = DATA / "images_unread"
FLAGS = cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR
ALL_ENTRIES = {(0, i) for i in range(len(VLC0))} | \
    {(1, i) for i in range(len(VLC1))}
# what the walker covers: every codeword, U-VLC values 1 to 15 in both
# kinds of quad row (16-bit samples without a wavelet reach U = 16, and
# kappa is at least 1), the three initial-row pair rules
WALK = ALL_ENTRIES | {("u", i, u) for i in (True, False)
                      for u in range(1, 16)} | \
    {("pair", r) for r in ("both>2", "first>2", "first<=2")}


def photo(h, w, seed, noise=8.0, top=255):
    """[h, w, 3] int64 in [0, top]: colour waves with noise and a flat
    square."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([0.5 + 0.4 * np.sin(xx / (5.0 + c) + c)
                    * np.cos(yy / 7.0 - c) for c in range(3)], -1)
    img = img * 255 + rng.normal(0, noise, img.shape)
    img[h // 4:h // 2, w // 4:w // 2] = 240
    return (np.clip(img, 0, 255) * (top / 255.0)).astype(np.int64)


def planes(img):
    return [img[..., c] for c in range(img.shape[-1])]


def plan_all(plane, passes, layers):
    """Every block coded down to `plane` (at most its Mb - 1) with
    `passes`, pass i in layer layers[i]."""
    return lambda c, r, band, b, q, Mb: H.BlockPlan(
        min(plane, Mb - 1), passes, layers)


def with_rgn(cs, comp, shift):
    """An RGN marker (maxshift) for a component, after COD."""
    at = cs.index(b"\xff\x5c")
    return cs[:at] + struct.pack(">HHBBB", 0xFF5E, 5, comp, 0, shift) + \
        cs[at:]


# ---------------------------------------------------------------------------
# the table walker
# ---------------------------------------------------------------------------

def _mu(E, rng):
    """A magnitude of exponent E (E = bit length of 2 (mu - 1) + 1)."""
    if E == 1:
        return 1
    return int(rng.integers(2 ** (E - 2) + 1, 2 ** (E - 1) + 1))


def _strip(rng, emax, w=64, h=4):
    """A 64 x 4 block of random quads: a random rho, an exponent bound U,
    some samples at U and the rest below it, random signs."""
    q = np.zeros((h, w), np.int64)
    for y in range(0, h, 2):
        for x in range(0, w, 2):
            rho = int(rng.integers(0, 16)) if rng.random() < 0.85 else 0
            if not rho:
                continue
            U = int(rng.integers(1, emax + 1)) if rng.random() < 0.5 \
                else int(rng.integers(1, 5))
            ns = [n for n in range(4) if rho >> n & 1]
            top = set(rng.choice(ns, int(rng.integers(1, len(ns) + 1)),
                                 replace=False).tolist())
            for n in ns:
                E = U if n in top or U == 1 else int(rng.integers(1, U))
                m = _mu(E, rng)
                q[y + (n & 1), x + (n >> 1)] = \
                    min(m, 32767) if rng.random() < 0.5 else -m
    return q


def walker_pick(used):
    """The table walker's choice: a codeword not used yet where one fits,
    else the one with the most e_k bits."""
    def pick(initial, c, rho, emb, opts):
        t = 0 if initial else 1
        pool = [o for o in opts if (t, o[4]) not in used] or opts
        return max(pool, key=lambda o: (H._popcount(o[0]), -o[3]))
    return pick


def walker(seed=11, tries=12):
    """The walker's 64 x 4 blocks, stacked: greedily, of `tries` random
    blocks the one that covers the most new items of WALK per byte,
    until it covers them all."""
    rng = np.random.default_rng(seed)
    used, strips = set(), []
    for _ in range(2000):
        if WALK <= used:
            break
        best = None
        for _ in range(tries):
            q = _strip(rng, 16 if rng.random() < 0.15 else 6)
            trial = set(used)
            seg = H.cleanup_segment(q, 0, pick=walker_pick(trial),
                                    used=trial)
            score = len((trial - used) & WALK) / (len(seg) + 50)
            if best is None or score > best[0]:
                best = (score, q, trial)
        if best[0] > 0:
            used = best[2]
            strips.append(best[1])
    else:
        raise SystemExit(f"the walker misses {sorted(WALK - used)[:8]}")
    return np.concatenate(strips, 0)


def vlc_all(used=None):
    """ht_vlc_all.j2k: the walker's blocks as 16-bit samples (plus
    32768) without a wavelet, each block coded with the walker's choice."""
    g = SOURCES["ht_vlc_all.j2k"]()
    used = set() if used is None else used
    cs = H.encode([g], bits=16, comps=[H.Comp(0, 6, 2)],
                  pick=walker_pick(used), used=used)
    return cs, g


# ---------------------------------------------------------------------------
# the fixtures: (bytes, the source where lossless)
# ---------------------------------------------------------------------------

def _grey8():
    g = SOURCES["ht_grey8_53.j2k"]()
    return H.encode([g], comps=[H.Comp(2, 6, 6)]), g


def _rct():
    img = SOURCES["ht_rgb8_rct.jp2"]()
    return H.encode(planes(img), mct=True, jp2=True,
                    comps=[H.Comp(3, 5, 5)]), img


def _ict():
    img = photo(64, 64, 62)
    return H.encode(planes(img), reversible=False, mct=True, jp2=True,
                    base_step=2.0, comps=[H.Comp(4, 5, 5)]), None


def _sigprop():
    g = photo(64, 64, 63, noise=12.0)[..., 0]
    return H.encode([g], comps=[H.Comp(2, 5, 5)],
                    plan=plan_all(2, 2, [0, 0])), None


def _magref(style=0x04, opj=False):
    img = photo(40, 48, 64)
    return H.encode(planes(img), mct=True, layers=2,
                    comps=[H.Comp(3, 4, 4, style)],
                    plan=plan_all(2, 3, [0, 1, 1]), opj_layers=opj), None


def _grey16(used=None):
    """Noise over waves, and a 0 / 65535 checkerboard at the top whose
    HH coefficients (131,070) are the largest a 16-bit component's 5/3
    gives: U = 18, u = 17 in an initial quad row."""
    g = SOURCES["ht_grey16.j2k"]()
    return H.encode([g], bits=16, comps=[H.Comp(5, 4, 4)], used=used), g


def _grey16_source():
    rng = np.random.default_rng(65)
    g = photo(40, 48, 65, top=65535)[..., 1]
    g = np.clip(g + rng.integers(-20000, 20000, g.shape), 0, 65535)
    yy, xx = np.mgrid[0:16, 0:16]
    g[0:16, 16:32] = ((yy + xx) % 2) * 65535
    return g


def _odd_tiles():
    img = SOURCES["ht_odd_tiles.jp2"]()
    prec = [(4, 4), (4, 4), (5, 5), (5, 5)]
    comps = [H.Comp(3, 5, 5, prec=prec), H.Comp(3, 4, 7),
             H.Comp(3, 5, 5, prec=prec)]
    return H.encode(planes(img), mct=True, jp2=True, tiles=(40, 32),
                    prog=H.RPCL, comps=comps), img


def _sparse(used=None):
    g = SOURCES["ht_sparse.j2k"]()
    return H.encode([g], comps=[H.Comp(1, 5, 5)], used=used), g


def _sparse_source():
    g = np.full((64, 128), 140, np.int64)
    for y, x, v in ((63, 63, 20), (62, 126, 250), (5, 90, 0), (40, 7, 200)):
        g[y, x] = v
    return g


def _texture():
    img = photo(64, 64, 67, noise=6.0)
    return H.encode(planes(img), mct=True, jp2=True, layers=2,
                    tiles=(32, 32), comps=[H.Comp(3, 4, 4)], cpf=True,
                    plan=plan_all(1, 3, [0, 0, 1])), None


def _jph():
    img = SOURCES["ht_rgb8.jph"]()
    return H.encode(planes(img), mct=True, jp2=True, brand=b"jph ",
                    comps=[H.Comp(2, 4, 4)]), img


def _some_blocks(hook, every=2):
    """A hook that rewrites every `every`-th block's segments."""
    seen = [0]

    def wrap(c, orient, q, pl, segs):
        seen[0] += 1
        return hook(segs) if seen[0] % every == 0 else segs
    return wrap


def _empty_refinement():
    g = photo(48, 48, 69)[..., 2]
    return H.encode([g], comps=[H.Comp(2, 4, 4)],
                    plan=plan_all(2, 2, [0, 0]),
                    block_hook=_some_blocks(lambda s: (s[0], b""))), None


# the seeded sources of the lossless fixtures, which cv2 decodes to
SOURCES = {
    "ht_grey8_53.j2k": lambda: photo(80, 96, 60)[..., 1],
    "ht_rgb8_rct.jp2": lambda: photo(48, 64, 61),
    "ht_grey16.j2k": _grey16_source,
    "ht_odd_tiles.jp2": lambda: photo(53, 71, 66),
    "ht_sparse.j2k": _sparse_source,
    "ht_vlc_all.j2k": lambda: walker() + 32768,
    "ht_rgb8.jph": lambda: photo(32, 32, 68),
}

FIXTURES = {
    "ht_grey8_53.j2k": _grey8,
    "ht_rgb8_rct.jp2": _rct,
    "ht_rgb8_97.jp2": _ict,
    "ht_sigprop.j2k": _sigprop,
    "ht_magref.j2k": _magref,
    "ht_layers_opj.j2k": lambda: _magref(0, True),
    "ht_grey16.j2k": _grey16,
    "ht_odd_tiles.jp2": _odd_tiles,
    "ht_sparse.j2k": _sparse,
    "ht_vlc_all.j2k": vlc_all,
    "ht_texture_64.jp2": _texture,
    "ht_rgb8.jph": _jph,
    "ht_empty_refinement.j2k": _empty_refinement,
}


def _scup(segs):
    d = bytearray(segs[0])
    v = len(d) + 1
    d[-1], d[-2] = v >> 4, (d[-2] & 0xF0) | (v & 0xF)
    return (bytes(d),) + tuple(segs[1:])


UNREAD_FIXTURES = {
    "ht_4passes.j2k": lambda: H.encode(
        [photo(32, 32, 70)[..., 0]], comps=[H.Comp(1, 4, 4)],
        plan=plan_all(2, 4, [0] * 4)),
    "ht_rgn.j2k": lambda: with_rgn(H.encode(
        [photo(32, 32, 71)[..., 0]], comps=[H.Comp(1, 4, 4)]), 0, 3),
    "ht_mixed.j2k": lambda: H.encode(
        [photo(32, 32, 72)[..., 0]], comps=[H.Comp(1, 4, 4, 0x80)]),
    "ht_scup.j2k": lambda: H.encode(
        [photo(32, 32, 73)[..., 0]], comps=[H.Comp(1, 4, 4)],
        block_hook=_some_blocks(_scup, 3)),
    "ht_layers_t814.j2k": lambda: _magref(0, False)[0],
    "ht_empty_cleanup.j2k": lambda: H.encode(
        [photo(32, 32, 74)[..., 0]], comps=[H.Comp(1, 4, 4)],
        block_hook=_some_blocks(lambda s: (b"",), 3)),
}


# ---------------------------------------------------------------------------
# checks and writing
# ---------------------------------------------------------------------------

def cv2_rgb(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), FLAGS)
    if img is None:
        return None
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def pillow_rgb(data):
    """Pillow's samples as [h, w, 3], or None where it reads nothing."""
    try:
        im = Image.open(io.BytesIO(data))
        im.load()
    except Exception:          # Pillow raises several kinds for these
        return None
    a = np.asarray(im)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    return a[..., :3]


def check_walker():
    """ht_vlc_all covers WALK; ht_grey16 reaches u = 16 and 17;
    ht_sparse passes through every MEL state."""
    used = set()
    vlc_all(used)
    if not WALK <= used:
        raise SystemExit(f"the walker misses {sorted(WALK - used)[:8]}")
    used = set()
    _grey16(used)
    if not {16, 17} <= {u[2] for u in used if u[0] == "u"}:
        raise SystemExit("ht_grey16 does not reach u = 16 and 17")
    used = set()
    _sparse(used)
    states = {u[1] for u in used if u[0] == "mel"}
    if states != set(range(13)):
        raise SystemExit(f"ht_sparse's MEL states: {sorted(states)}")


def main():
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    check_walker()
    OUT.mkdir(parents=True, exist_ok=True)
    UNREAD.mkdir(parents=True, exist_ok=True)
    npz = OUT / "cv2_pixels.npz"
    pixels = dict(np.load(npz)) if npz.exists() else {}
    made = {}
    for name, make in FIXTURES.items():
        data, src = make()
        px = cv2_rgb(data)
        if px is None:
            raise SystemExit(f"cv2 reads nothing of {name}")
        if src is not None:
            want = src if src.ndim == 3 else np.repeat(src[..., None], 3, -1)
            if not np.array_equal(px.astype(np.int64), want):
                raise SystemExit(f"cv2's {name} is not its source")
        pil = pillow_rgb(data)
        if pil is not None and not np.array_equal(pil, px):
            raise SystemExit(f"Pillow reads {name} otherwise than cv2")
        made[name] = (data, px, pil is not None, src is not None)
    for name, make in UNREAD_FIXTURES.items():
        data = make()
        if cv2_rgb(data) is not None or pillow_rgb(data) is not None:
            raise SystemExit(f"cv2 or Pillow reads {name}")
        (UNREAD / name).write_bytes(data)
        print(f"{name}: {len(data)} bytes, cv2 and Pillow read nothing")
    for name, (data, px, pil, lossless) in made.items():
        (OUT / name).write_bytes(data)
        pixels[name] = px
        print(f"{name}: {len(data)} bytes, {px.shape} {px.dtype}"
              f"{', lossless' if lossless else ''}"
              f"{', Pillow agrees' if pil else ''}")
    buf = io.BytesIO()
    np.savez_compressed(buf, **pixels)
    npz.write_bytes(buf.getvalue())


if __name__ == "__main__":
    sys.exit(main())
