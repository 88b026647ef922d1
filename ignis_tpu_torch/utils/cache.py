"""Content-addressed asset cache (the reference's CacheManager; a port of
ignis_tpu/utils/cache.py).

Converted assets are cached under a SHA256 key so that repeated scene
loads skip the conversion:

- ``cached_mesh(path, loader, variant)``: hash(file bytes + variant) ->
  the parsed TriMesh's {vertices, indices, normals, uvs};
- ``cached_arrays(tag, key_parts, builder)``: hash of the input buffers
  -> a dict of named arrays (the built BVH8 of a soup).

Every key starts with this package's tag (`_TAG`), and every file name
with ``torch_``, so a directory shared with the JAX package never hands
the port one of its artifacts (that package builds another BVH layout).
Off unless IGNIS_TPU_CACHE_DIR is set or ``enable()`` is called: scene
loads stay deterministic for tests that patch loaders.
"""
from __future__ import annotations

import hashlib
import os
import zipfile
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

_TAG = "ignis_tpu_torch|1"   # bump the number to invalidate every artifact
_enabled_dir: Optional[Path] = None


def cache_dir() -> Optional[Path]:
    if _enabled_dir is not None:
        return _enabled_dir
    d = os.environ.get("IGNIS_TPU_CACHE_DIR")
    return Path(d) if d else None


def enable(path=None) -> Path:
    """Turn the cache on for this process (defaults to ~/.cache/ignis_tpu)."""
    global _enabled_dir
    _enabled_dir = Path(path) if path else \
        Path(os.path.expanduser("~/.cache/ignis_tpu"))
    _enabled_dir.mkdir(parents=True, exist_ok=True)
    return _enabled_dir


def disable():
    global _enabled_dir
    _enabled_dir = None


def _hash_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _load_npz(f: Path) -> Optional[Dict[str, np.ndarray]]:
    try:
        with np.load(f, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
        try:
            f.unlink()  # corrupt or truncated entry: drop it
        except OSError:
            pass
        return None


def _store_npz(f: Path, arrays: Dict[str, np.ndarray]):
    # np.savez appends ".npz" unless the name already ends with it
    tmp = f.with_name(f.stem + ".tmp-%d.npz" % os.getpid())
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, f)
    except OSError:
        try:
            tmp.unlink()
        except OSError:
            pass


def cached_mesh(path, loader: Callable[[], "object"], variant: str = ""):
    """Run ``loader()`` (returning a TriMesh) through the cache.

    Key = sha256(file bytes) + variant (e.g. shape_index). The parsed
    TriMesh's arrays are stored; normals and uvs may be absent.
    """
    d = cache_dir()
    if d is None:
        return loader()
    d.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(
        (_TAG + "|mesh|" + _hash_file(path) + "|" + variant)
        .encode()).hexdigest()
    f = d / f"torch_mesh_{key}.npz"
    if f.exists():
        z = _load_npz(f)
        if z is not None:
            from ..scene.mesh import TriMesh
            return TriMesh(
                z["vertices"], z["indices"],
                z["normals"] if z["normals"].size else None,
                z["uvs"] if z["uvs"].size else None)
    m = loader()
    _store_npz(f, {
        "vertices": np.asarray(m.vertices, np.float32),
        "indices": np.asarray(m.indices, np.int32),
        "normals": (np.asarray(m.normals, np.float32)
                    if m.normals is not None
                    else np.zeros((0, 3), np.float32)),
        "uvs": (np.asarray(m.texcoords, np.float32)
                if m.texcoords is not None else np.zeros((0, 2), np.float32)),
    })
    return m


def cached_arrays(tag: str, key_parts,
                  builder: Callable[[], Dict[str, np.ndarray]]):
    """Content-addressed cache of a dict of arrays (built BVHs).

    ``key_parts``: ndarrays, bytes or strings hashed into the key.
    ``builder()`` -> {name: ndarray}. Returns the (possibly cached) dict.
    """
    d = cache_dir()
    if d is None:
        return builder()
    d.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256((_TAG + "|" + tag).encode())
    for p in key_parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        elif isinstance(p, bytes):
            h.update(p)
        else:
            h.update(str(p).encode())
    f = d / f"torch_{tag}_{h.hexdigest()}.npz"
    if f.exists():
        z = _load_npz(f)
        if z is not None:
            return z
    out = builder()
    _store_npz(f, out)
    return out
