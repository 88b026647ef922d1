"""Host-side triangle mesh, the primitive generators and the mesh file IO.

Copied from ignis_tpu/scene/mesh.py (which cannot be imported without JAX,
through ignis_tpu/__init__.py): the TriMesh class; the triangle, plane,
rectangle, box, icosphere, uvsphere, disk, cone, cylinder and gaussian
generators; the PLY (ascii and binary), OBJ and Mitsuba .serialized
loaders and the OBJ and PLY writers, unchanged but for one addition:
`load_ply` reads a binary face list of triangles only in one numpy pass
(the loop of the copy took seconds on a 327,680-face file) and falls back
to the face loop otherwise. The JAX package's content-addressed mesh
cache (ignis_tpu/utils/cache.py, off unless an environment variable names
its directory) is not carried: files are parsed at every load. All numpy,
runs at scene build time only.
"""
from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    normals: Optional[np.ndarray] = None   # per-vertex
    texcoords: Optional[np.ndarray] = None

    @property
    def face_count(self) -> int:
        return len(self.indices)

    # -- derived quantities -------------------------------------------------
    def face_normals_areas(self):
        v = self.vertices
        i = self.indices
        e1 = v[i[:, 1]] - v[i[:, 0]]
        e2 = v[i[:, 2]] - v[i[:, 0]]
        c = np.cross(e1, e2)
        norm = np.linalg.norm(c, axis=1)
        area = 0.5 * norm
        n = c / np.where(norm > 0, norm, 1.0)[:, None]
        return n.astype(np.float32), area.astype(np.float32)

    def compute_vertex_normals(self):
        fn, area = self.face_normals_areas()
        vn = np.zeros_like(self.vertices, dtype=np.float64)
        w = (fn * area[:, None]).astype(np.float64)
        for k in range(3):
            np.add.at(vn, self.indices[:, k], w)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        self.normals = (vn / np.where(norm > 0, norm, 1.0)).astype(np.float32)

    def setup_face_normals_as_vertex_normals(self):
        """Split vertices so each face has constant (face) normals."""
        fn, _ = self.face_normals_areas()
        nf = self.face_count
        new_v = self.vertices[self.indices.reshape(-1)]
        new_n = np.repeat(fn, 3, axis=0)
        new_t = (self.texcoords[self.indices.reshape(-1)]
                 if self.texcoords is not None else None)
        self.vertices = new_v
        self.normals = new_n.astype(np.float32)
        self.texcoords = new_t
        self.indices = np.arange(nf * 3, dtype=np.int32).reshape(nf, 3)

    def flip_normals(self):
        self.indices = self.indices[:, [0, 2, 1]].copy()
        if self.normals is not None:
            self.normals = -self.normals

    def transform(self, m: np.ndarray):
        m = np.asarray(m, np.float64)
        v = self.vertices.astype(np.float64)
        self.vertices = (v @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        if self.normals is not None:
            # Normals transform by inverse-transpose of the linear part
            lin = m[:3, :3]
            nmat = np.linalg.inv(lin).T
            n = self.normals.astype(np.float64) @ nmat.T
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            self.normals = (n / np.where(norm > 0, norm, 1.0)).astype(np.float32)
        if np.linalg.det(m[:3, :3]) < 0:
            # Keep face winding consistent with vertex normals
            self.indices = self.indices[:, [0, 2, 1]].copy()

    def subdivide(self, mask=None):
        """4:1 midpoint subdivision (reference TriMesh::subdivide)."""
        v = self.vertices
        idx = self.indices
        if mask is None:
            mask = np.ones(len(idx), bool)
        edge_map = {}
        verts = [v]
        normals = [self.normals] if self.normals is not None else None
        uvs = [self.texcoords] if self.texcoords is not None else None
        next_id = len(v)
        extra_v, extra_n, extra_t = [], [], []

        def midpoint(a, b):
            nonlocal next_id
            key = (min(a, b), max(a, b))
            if key in edge_map:
                return edge_map[key]
            extra_v.append(0.5 * (v[a] + v[b]))
            if normals is not None:
                n = self.normals[a].astype(np.float64) + self.normals[b]
                ln = np.linalg.norm(n)
                extra_n.append(n / ln if ln > 0 else n)
            if uvs is not None:
                extra_t.append(0.5 * (self.texcoords[a] + self.texcoords[b]))
            edge_map[key] = next_id
            next_id += 1
            return edge_map[key]

        new_faces = []
        for f, (a, b, c) in enumerate(idx):
            if not mask[f]:
                new_faces.append((a, b, c))
                continue
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]

        if extra_v:
            self.vertices = np.vstack([v, np.asarray(extra_v, np.float32)])
            if normals is not None:
                self.normals = np.vstack([self.normals, np.asarray(extra_n, np.float32)])
            if uvs is not None:
                self.texcoords = np.vstack([self.texcoords, np.asarray(extra_t, np.float32)])
        self.indices = np.asarray(new_faces, np.int32)

    def ensure_attributes(self):
        if self.normals is None or len(self.normals) != len(self.vertices):
            self.compute_vertex_normals()
        if self.texcoords is None or len(self.texcoords) != len(self.vertices):
            self.texcoords = np.zeros((len(self.vertices), 2), np.float32)


# ---------------------------------------------------------------------------
# Primitive generators (defaults match TriMeshProvider.cpp)
# ---------------------------------------------------------------------------

def _add(meshes):
    verts, faces, norms, uvs = [], [], [], []
    off = 0
    for m in meshes:
        m.ensure_attributes()
        verts.append(m.vertices)
        norms.append(m.normals)
        uvs.append(m.texcoords)
        faces.append(m.indices + off)
        off += len(m.vertices)
    return TriMesh(np.vstack(verts), np.vstack(faces).astype(np.int32),
                   np.vstack(norms), np.vstack(uvs))


def make_triangle(p0, p1, p2) -> TriMesh:
    p0, p1, p2 = [np.asarray(p, np.float32) for p in (p0, p1, p2)]
    n = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(n)
    n = n / ln if ln > 0 else n
    return TriMesh(
        vertices=np.stack([p0, p1, p2]).astype(np.float32),
        indices=np.array([[0, 1, 2]], np.int32),
        normals=np.tile(n, (3, 1)).astype(np.float32),
        texcoords=np.array([[0, 0], [1, 0], [0, 1]], np.float32),
    )


def make_plane(origin, x_axis, y_axis) -> TriMesh:
    origin, x, y = [np.asarray(p, np.float64) for p in (origin, x_axis, y_axis)]
    n = np.cross(x, y)
    ln = np.linalg.norm(n)
    n = n / ln if ln > 0 else n
    vs = np.stack([origin, origin + x, origin + x + y, origin + y])
    return TriMesh(
        vertices=vs.astype(np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        normals=np.tile(n, (4, 1)).astype(np.float32),
        texcoords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
    )


def make_rectangle(p0, p1, p2, p3) -> TriMesh:
    p0, p1, p2, p3 = [np.asarray(p, np.float32) for p in (p0, p1, p2, p3)]
    t1 = make_triangle(p0, p1, p3)
    t2 = make_triangle(p1, p2, p3)
    return _add([t1, t2])


def make_box(origin, x, y, z) -> TriMesh:
    origin, x, y, z = [np.asarray(p, np.float64) for p in (origin, x, y, z)]
    lll = origin
    hhh = origin + x + y + z
    return _add([
        make_plane(lll, y, x),
        make_plane(lll, x, z),
        make_plane(lll, z, y),
        make_plane(hhh, -x, -y),
        make_plane(hhh, -z, -x),
        make_plane(hhh, -y, -z),
    ])


def make_ico_sphere(center, radius, subdivisions=4) -> TriMesh:
    # Icosahedron base
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    # `subdivisions` REFINEMENT ROUNDS from the 20-face icosahedron
    # (reference TriMesh::MakeIcoSphere, TriMesh.cpp:955): 20*4^n tris.
    for _ in range(max(0, int(subdivisions))):
        edge = {}
        new_faces = []
        vlist = [verts]
        nid = len(verts)

        def mid(a, b):
            nonlocal nid
            key = (min(a, b), max(a, b))
            if key not in edge:
                p = verts[a] + verts[b]
                p = p / np.linalg.norm(p)
                vlist.append(p[None])
                edge[key] = nid
                nid += 1
            return edge[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        verts = np.vstack(vlist)
        faces = np.asarray(new_faces, np.int32)
    m = TriMesh(vertices=verts.astype(np.float32), indices=faces,
                normals=verts.astype(np.float32))
    _spherical_uv(m)
    center = np.asarray(center, np.float64)
    tr = np.eye(4)
    tr[:3, 3] = center
    tr[:3, :3] *= radius
    m.transform(tr)
    return m


def _spherical_uv(m: TriMesh):
    n = m.normals
    theta = np.arccos(np.clip(n[:, 2], -1, 1))
    phi = np.arctan2(-n[:, 0], n[:, 1])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    m.texcoords = np.stack([phi / (2 * np.pi), theta / np.pi], axis=1).astype(np.float32)


def make_uv_sphere(center, radius, stacks=32, slices=16) -> TriMesh:
    stacks = max(2, stacks)
    slices = max(2, slices)
    center = np.asarray(center, np.float64)
    vs, ns, uv, faces = [], [], [], []
    for j in range(slices + 1):
        theta = np.pi * j / slices
        for i in range(stacks + 1):
            phi = 2 * np.pi * i / stacks
            n = np.array([math.sin(theta) * math.cos(phi),
                          math.sin(theta) * math.sin(phi),
                          math.cos(theta)])
            vs.append(center + radius * n)
            ns.append(n)
            uv.append([i / stacks, j / slices])
    w = stacks + 1
    for j in range(slices):
        for i in range(stacks):
            a = j * w + i
            b = j * w + i + 1
            c = (j + 1) * w + i + 1
            d = (j + 1) * w + i
            # winding: (a,d,c)/(a,c,b) makes face normals point outward
            faces += [(a, d, c), (a, c, b)]
    return TriMesh(np.asarray(vs, np.float32), np.asarray(faces, np.int32),
                   np.asarray(ns, np.float32), np.asarray(uv, np.float32))


def _disk_mesh(origin, n, nx, ny, radius, sections, fill_cap, flip=False) -> TriMesh:
    vs = []
    ns = []
    uv = []
    faces = []
    if fill_cap:
        vs.append(origin)
        ns.append(n)
        uv.append([0, 0])
    for i in range(sections):
        x = math.cos(2 * np.pi * i / sections)
        y = math.sin(2 * np.pi * i / sections)
        vs.append(origin + radius * nx * x + radius * ny * y)
        ns.append(n)
        uv.append([0.5 * (x + 1), 0.5 * (y + 1)])
    if fill_cap:
        for i in range(sections):
            c = i + 1
            nc = (i + 1) % sections + 1
            faces.append((0, nc, c) if flip else (0, c, nc))
    return TriMesh(np.asarray(vs, np.float32),
                   np.asarray(faces, np.int32).reshape(-1, 3),
                   np.asarray(ns, np.float32), np.asarray(uv, np.float32))


def make_disk(center, normal, radius, sections=32) -> TriMesh:
    center = np.asarray(center, np.float64)
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    nx, ny = _tangent_frame(normal)
    return _disk_mesh(center, normal, nx, ny, radius, sections, True)


def _tangent_frame(n):
    sign = math.copysign(1.0, n[2])
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    t = np.array([1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0]])
    bt = np.array([b, sign + n[1] * n[1] * a, -n[1]])
    return t, bt


def make_cone(base_center, base_radius, tip, sections=32, fill_cap=True) -> TriMesh:
    base_center = np.asarray(base_center, np.float64)
    tip = np.asarray(tip, np.float64)
    h = base_center - tip
    h = h / np.linalg.norm(h)
    nx, ny = _tangent_frame(h)
    m = _disk_mesh(base_center, h, nx, ny, base_radius, sections, fill_cap)
    vs = list(m.vertices)
    ns = list(m.normals)
    uv = list(m.texcoords)
    faces = list(map(tuple, m.indices))
    tp = len(vs)
    vs.append(tip)
    ns.append(h)
    uv.append([0, 0])
    start = 1 if fill_cap else 0
    for i in range(sections):
        c = i + start
        nc = (i + 1) % sections + start
        faces.append((c, tp, nc))
    mesh = TriMesh(np.asarray(vs, np.float32), np.asarray(faces, np.int32),
                   None, np.asarray(uv, np.float32))
    mesh.compute_vertex_normals()
    return mesh


def make_cylinder(base_center, base_radius, top_center, top_radius,
                  sections=32, fill_cap=True) -> TriMesh:
    base_center = np.asarray(base_center, np.float64)
    top_center = np.asarray(top_center, np.float64)
    h = base_center - top_center
    h = h / np.linalg.norm(h)
    nx, ny = _tangent_frame(h)
    parts = []
    if fill_cap:
        parts.append(_disk_mesh(base_center, h, nx, ny, base_radius, sections, True))
        parts.append(_disk_mesh(top_center, -h, nx, ny, top_radius, sections, True, flip=True))
    vs, ns, uv, faces = [], [], [], []
    for i in range(sections):
        x = math.cos(2 * np.pi * i / sections)
        y = math.sin(2 * np.pi * i / sections)
        r = nx * x + ny * y
        vs += [base_center + base_radius * r, top_center + top_radius * r]
        ns += [r, r]
        uv += [[i / sections, 0], [i / sections, 1]]
    for i in range(sections):
        a = 2 * i
        b = 2 * i + 1
        c = (2 * i + 2) % (2 * sections)
        d = (2 * i + 3) % (2 * sections)
        faces += [(a, c, b), (b, c, d)]
    side = TriMesh(np.asarray(vs, np.float32), np.asarray(faces, np.int32),
                   np.asarray(ns, np.float32), np.asarray(uv, np.float32))
    parts.append(side)
    return _add(parts)


# ---------------------------------------------------------------------------
# File loaders: PLY (ascii + binary LE) and OBJ
# ---------------------------------------------------------------------------

def _ply_triangles(body, off, el, cnt_t, idx_t):
    """The [F, 3] indices of a binary face element whose only property is
    its vertex list and whose every face is a triangle, read at once; None
    when the element is not such a list."""
    if len(el["props"]) != 1:
        return None
    dt = np.dtype([("n", cnt_t), ("i", idx_t, (3,))])
    count = el["count"]
    if len(body) - off < dt.itemsize * count:
        return None
    rec = np.frombuffer(body, dt, count=count, offset=off)
    if not np.all(rec["n"] == 3):
        return None
    return rec["i"]


def load_ply(path) -> TriMesh:
    data = Path(path).read_bytes()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(type, name)...])
    cur = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = {"name": tok[1], "count": int(tok[2]), "props": []}
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                cur["props"].append(("list", tok[2], tok[3], tok[4]))
            else:
                cur["props"].append(("scalar", tok[1], tok[2]))

    type_map = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
                "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
                "uint": "u4", "uint32": "u4"}

    verts = norms = uvs = None
    faces = []
    blocks = []   # [F, 3] index arrays of the faces read at once
    if fmt.startswith("binary"):
        endian = "<" if "little" in fmt else ">"
        off = 0
        for el in elements:
            if el["name"] == "vertex":
                names = [p[2] for p in el["props"] if p[0] == "scalar"]
                dt = np.dtype([(p[2], endian + type_map[p[1]])
                               for p in el["props"] if p[0] == "scalar"])
                arr = np.frombuffer(body, dt, count=el["count"], offset=off)
                off += dt.itemsize * el["count"]
                verts = np.stack([arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)
                if all(k in names for k in ("nx", "ny", "nz")):
                    norms = np.stack([arr["nx"], arr["ny"], arr["nz"]], 1).astype(np.float32)
                if all(k in names for k in ("s", "t")):
                    uvs = np.stack([arr["s"], arr["t"]], 1).astype(np.float32)
                elif all(k in names for k in ("u", "v")):
                    uvs = np.stack([arr["u"], arr["v"]], 1).astype(np.float32)
            elif el["name"] == "face":
                lp = next(p for p in el["props"] if p[0] == "list")
                cnt_t = np.dtype(endian + type_map[lp[1]])
                idx_t = np.dtype(endian + type_map[lp[2]])
                tri = _ply_triangles(body, off, el, cnt_t, idx_t)
                if tri is not None:
                    blocks.append(tri.astype(np.int32))
                    off += len(tri) * (cnt_t.itemsize + 3 * idx_t.itemsize)
                    continue
                for _ in range(el["count"]):
                    (cnt,) = struct.unpack_from(
                        endian + {"u1": "B", "i1": "b", "u4": "I", "i4": "i",
                                  "u2": "H", "i2": "h"}[type_map[lp[1]]], body, off)
                    off += cnt_t.itemsize
                    ids = np.frombuffer(body, idx_t, count=cnt, offset=off)
                    off += idx_t.itemsize * cnt
                    for k in range(1, cnt - 1):  # fan triangulation
                        faces.append((ids[0], ids[k], ids[k + 1]))
            else:
                # Skip unknown fixed-size elements
                sz = sum(np.dtype(endian + type_map[p[1]]).itemsize
                         for p in el["props"] if p[0] == "scalar")
                off += sz * el["count"]
    else:
        lines = body.decode("ascii", "replace").split("\n")
        li = 0
        for el in elements:
            if el["name"] == "vertex":
                names = [p[2] for p in el["props"] if p[0] == "scalar"]
                rows = []
                for _ in range(el["count"]):
                    rows.append([float(x) for x in lines[li].split()])
                    li += 1
                arr = np.asarray(rows, np.float32)
                cols = {n: arr[:, k] for k, n in enumerate(names)}
                verts = np.stack([cols["x"], cols["y"], cols["z"]], 1)
                if all(k in cols for k in ("nx", "ny", "nz")):
                    norms = np.stack([cols["nx"], cols["ny"], cols["nz"]], 1)
                if all(k in cols for k in ("s", "t")):
                    uvs = np.stack([cols["s"], cols["t"]], 1)
            elif el["name"] == "face":
                for _ in range(el["count"]):
                    tok = [int(x) for x in lines[li].split()]
                    li += 1
                    cnt = tok[0]
                    ids = tok[1:1 + cnt]
                    for k in range(1, cnt - 1):
                        faces.append((ids[0], ids[k], ids[k + 1]))
            else:
                li += el["count"]

    idx = np.asarray(faces, np.int32)
    if blocks:
        idx = np.concatenate([idx.reshape(-1, 3)] + blocks)
    mesh = TriMesh(verts, idx, norms, uvs)
    return mesh


def load_obj(path, shape_index: int = -1) -> TriMesh:
    """Minimal OBJ loader: v/vn/vt + polygonal faces (fan-triangulated)."""
    vs, vns, vts = [], [], []
    faces = []  # ((vi, ti, ni) * 3)
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vt":
                vts.append([float(x) for x in tok[1:3]])
            elif tok[0] == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))

    nv = len(vs)
    nt = len(vts)
    nn = len(vns)

    def rix(i, n):
        return i - 1 if i > 0 else n + i

    # Expand to per-corner attributes (OBJ indexes attributes independently)
    out_v, out_n, out_t, out_f = [], [], [], []
    cache = {}
    for tri in faces:
        ids = []
        for (vi, ti, ni) in tri:
            key = (vi, ti, ni)
            if key not in cache:
                cache[key] = len(out_v)
                out_v.append(vs[rix(vi, nv)])
                out_n.append(vns[rix(ni, nn)] if ni else [0, 0, 0])
                out_t.append(vts[rix(ti, nt)] if ti else [0, 0])
            ids.append(cache[key])
        out_f.append(ids)

    mesh = TriMesh(np.asarray(out_v, np.float32),
                   np.asarray(out_f, np.int32),
                   np.asarray(out_n, np.float32) if nn else None,
                   np.asarray(out_t, np.float32) if nt else None)
    if mesh.normals is not None and not np.any(np.linalg.norm(mesh.normals, axis=1) > 0.5):
        mesh.normals = None
    return mesh


def load_mesh_file(path) -> TriMesh:
    suffix = Path(path).suffix.lower()
    if suffix == ".ply":
        return load_ply(path)
    if suffix == ".obj":
        return load_obj(path)
    if suffix == ".serialized" or suffix == ".mts":
        return load_mts_serialized(path)
    raise ValueError(f"Unsupported mesh format: {path}")


def save_obj(path, mesh: TriMesh):
    """Wavefront OBJ writer (igutil convert_ply_obj analog)."""
    with open(path, "w") as f:
        f.write("# ignis_tpu mesh\n")
        for v in mesh.vertices:
            f.write("v %.9g %.9g %.9g\n" % (v[0], v[1], v[2]))
        has_n = mesh.normals is not None and len(mesh.normals)
        has_t = mesh.texcoords is not None and len(mesh.texcoords)
        if has_n:
            for n in mesh.normals:
                f.write("vn %.9g %.9g %.9g\n" % (n[0], n[1], n[2]))
        if has_t:
            for t in mesh.texcoords:
                f.write("vt %.9g %.9g\n" % (t[0], t[1]))
        for tri in mesh.indices:
            idx = [i + 1 for i in tri]
            if has_n and has_t:
                f.write("f %d/%d/%d %d/%d/%d %d/%d/%d\n" % (
                    idx[0], idx[0], idx[0], idx[1], idx[1], idx[1],
                    idx[2], idx[2], idx[2]))
            elif has_n:
                f.write("f %d//%d %d//%d %d//%d\n" % (
                    idx[0], idx[0], idx[1], idx[1], idx[2], idx[2]))
            else:
                f.write("f %d %d %d\n" % tuple(idx))


def save_ply(path, mesh: TriMesh):
    """Binary little-endian PLY writer (igutil convert_obj_ply analog)."""
    mesh.ensure_attributes()
    n_v = len(mesh.vertices)
    n_f = len(mesh.indices)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z",
              "property float nx", "property float ny", "property float nz",
              "property float u", "property float v",
              f"element face {n_f}",
              "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        inter = np.hstack([mesh.vertices.astype("<f4"),
                           mesh.normals.astype("<f4"),
                           mesh.texcoords.astype("<f4")])
        f.write(inter.tobytes())
        faces = np.empty((n_f, 13), np.uint8)
        faces[:, 0] = 3
        faces[:, 1:] = mesh.indices.astype("<i4").view(np.uint8).reshape(n_f, 12)
        f.write(faces.tobytes())


# ---------------------------------------------------------------------------
# Analytic gaussian shapes (reference TriMesh.cpp:1131 MakeRadialGaussian,
# :1187 MakeGaussianLobe)
# ---------------------------------------------------------------------------

def make_radial_gaussian(origin, direction, sigma=1.0, radius_scale=1.0,
                         sections=32, slices=16) -> TriMesh:
    """Surface-of-revolution gaussian bump: rings at normalized radius
    r = 1 - i/slices lifted by g(r) = exp(-r^2/(2 sigma^2))/(2 pi sigma),
    shifted so the rim (r=1) sits on the base plane."""
    sections = max(3, int(sections))
    slices = max(2, int(slices))
    origin = np.asarray(origin, np.float64)
    direction = np.asarray(direction, np.float64)
    normal = direction / max(np.linalg.norm(direction), 1e-12)
    nx, ny = _tangent_frame(normal)

    def gauss(r):
        return math.exp(-(r * r) / (2.0 * sigma * sigma)) / (sigma * 2.0 * np.pi)

    defect = direction * gauss(1.0)
    ang = 2.0 * np.pi * np.arange(sections) / sections
    ring_dirs = np.outer(np.cos(ang), nx) + np.outer(np.sin(ang), ny)  # [S,3]

    vs = [origin]  # bottom-disk center
    uv = [[0.0, 0.0]]
    faces = []
    # ring 0 = bottom rim (on the base plane), rings 1..slices-1 rise
    for i in range(slices):
        r = 1.0 - i / slices
        center = origin + direction * gauss(r) - defect
        for k in range(sections):
            d = ring_dirs[k]
            vs.append(center + radius_scale * r * d)
            uv.append([0.5 * (math.cos(ang[k]) + 1), 0.5 * (math.sin(ang[k]) + 1)])
    # bottom cap
    for k in range(sections):
        c, nc = k + 1, (k + 1) % sections + 1
        faces.append((0, c, nc))
    # side quads between consecutive rings
    for i in range(1, slices):
        start = (i - 1) * sections + 1
        for k in range(sections):
            c = k + start
            nc = (k + 1) % sections + start
            faces += [(c, c + sections, nc), (c + sections, nc + sections, nc)]
    # peak
    peak = origin + direction * gauss(0.0) - defect
    tp = len(vs)
    vs.append(peak)
    uv.append([0.0, 0.0])
    start = (slices - 1) * sections + 1
    for k in range(sections):
        c = k + start
        nc = (k + 1) % sections + start
        faces.append((c, tp, nc))
    mesh = TriMesh(np.asarray(vs, np.float32),
                   np.asarray(faces, np.int32), None,
                   np.asarray(uv, np.float32))
    mesh.compute_vertex_normals()
    return mesh


def make_gaussian_lobe(origin, direction, x_axis, y_axis, cov,
                       theta_size=64, phi_size=128, scale=1.0) -> TriMesh:
    """Spherical plot of an anisotropic gaussian over (theta, phi): each grid
    direction u(theta,phi) is scaled by the 2D gaussian density centred at
    `direction` (in the x/y-axis tangent frame)."""
    theta_size = max(8, int(theta_size))
    phi_size = max(8, int(phi_size))
    origin = np.asarray(origin, np.float64)
    nx = np.asarray(x_axis, np.float64)
    ny = np.asarray(y_axis, np.float64)
    nx = nx / max(np.linalg.norm(nx), 1e-12)
    ny = ny / max(np.linalg.norm(ny), 1e-12)
    n = np.cross(nx, ny)
    n = n / max(np.linalg.norm(n), 1e-12)
    cov = np.asarray(cov, np.float64).reshape(2, 2)
    det = abs(np.linalg.det(cov))
    if det <= 1e-12:
        return TriMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    inv_cov = np.linalg.inv(cov)
    norm_f = 1.0 / (2.0 * np.pi * math.sqrt(det))

    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    local = np.array([np.dot(nx, d), np.dot(ny, d), np.dot(n, d)])
    mean_theta = math.acos(np.clip(local[2], -1.0, 1.0))
    mean_phi = math.atan2(local[1], local[0])

    thetas = np.pi * np.arange(theta_size + 1) / theta_size          # [0, pi]
    phis = 2.0 * np.pi * np.arange(phi_size + 1) / phi_size - np.pi  # [-pi, pi]
    tt, pp = np.meshgrid(thetas, phis)                   # [phi+1, theta+1]
    a0 = tt - mean_theta
    a1 = pp - mean_phi
    quad = (inv_cov[0, 0] * a0 * a0 + (inv_cov[0, 1] + inv_cov[1, 0]) * a0 * a1
            + inv_cov[1, 1] * a1 * a1)
    val = norm_f * np.exp(-0.5 * quad) * scale
    st, ct = np.sin(tt), np.cos(tt)
    u = (np.outer((st * np.cos(pp)).ravel(), nx)
         + np.outer((st * np.sin(pp)).ravel(), ny)
         + np.outer(ct.ravel(), n))
    verts = (origin[None, :] + u * val.ravel()[:, None]).astype(np.float32)

    w = theta_size + 1
    jj, ii = np.meshgrid(np.arange(phi_size), np.arange(theta_size),
                         indexing="ij")
    i1 = (jj * w + ii).ravel()
    i2 = ((jj + 1) * w + ii).ravel()
    faces = np.concatenate([
        np.stack([i1, i1 + 1, i2 + 1], axis=1),
        np.stack([i1, i2 + 1, i2], axis=1)], axis=0).astype(np.int32)
    uvs = np.stack([(tt / np.pi).ravel(), (pp / (2 * np.pi) + 0.5).ravel()],
                   axis=1).astype(np.float32)
    mesh = TriMesh(verts, faces, None, uvs)
    mesh.compute_vertex_normals()
    return mesh


# ---------------------------------------------------------------------------
# Mitsuba .serialized loader (reference mesh/MtsSerializedFile.cpp)
# ---------------------------------------------------------------------------

_MTS_VERTEXNORMALS = 0x0001
_MTS_TEXCOORDS = 0x0002
_MTS_VERTEXCOLORS = 0x0008
_MTS_DOUBLE = 0x2000


def load_mts_serialized(path, shape_index: int = 0) -> TriMesh:
    """Mitsuba .serialized mesh: zlib-compressed per-shape chunks with an
    offset dictionary at the end of file (MtsSerializedFile.cpp:163)."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    ident, version = struct.unpack_from("<HH", data, 0)
    if ident != 0x041C:
        raise ValueError(f"{path}: not a Mitsuba serialized file")
    if version < 3:
        raise ValueError(f"{path}: unsupported version {version}")

    (shape_count,) = struct.unpack_from("<I", data, len(data) - 4)
    if shape_index >= shape_count:
        raise ValueError(f"{path}: shape index {shape_index} out of range "
                         f"({shape_count} shapes)")
    osz = 8 if version >= 4 else 4
    fmt = "<Q" if version >= 4 else "<I"
    dict_off = len(data) - 4 - osz * shape_count
    (start,) = struct.unpack_from(fmt, data, dict_off + osz * shape_index)
    # decompressobj stops at the zlib stream end, so whatever follows this
    # shape's chunk (next shape or the offset dictionary) is ignored
    raw = zlib.decompressobj().decompress(data[int(start) + 4:])
    pos = 0

    def take(n):
        nonlocal pos
        out = raw[pos:pos + n]
        pos += n
        return out

    (flags,) = struct.unpack("<I", take(4))
    if version >= 4:  # skip utf8 shape name
        while raw[pos] != 0:
            pos += 1
        pos += 1
    vcount, tcount = struct.unpack("<QQ", take(16))
    ft = np.float64 if (flags & _MTS_DOUBLE) else np.float32
    fs = np.dtype(ft).itemsize

    verts = np.frombuffer(take(3 * fs * vcount), ft).reshape(-1, 3)
    normals = None
    if flags & _MTS_VERTEXNORMALS:
        normals = np.frombuffer(take(3 * fs * vcount), ft).reshape(-1, 3)
    uvs = None
    if flags & _MTS_TEXCOORDS:
        uvs = np.frombuffer(take(2 * fs * vcount), ft).reshape(-1, 2)
    if flags & _MTS_VERTEXCOLORS:
        take(3 * fs * vcount)  # ignored, as in the reference
    it = np.uint64 if vcount > 0xFFFFFFFF else np.uint32
    isz = np.dtype(it).itemsize
    idx = np.frombuffer(take(3 * isz * tcount), it).reshape(-1, 3)

    mesh = TriMesh(verts.astype(np.float32), idx.astype(np.int32),
                   normals.astype(np.float32) if normals is not None else None,
                   uvs.astype(np.float32) if uvs is not None else None)
    if normals is None:
        mesh.compute_vertex_normals()
    return mesh
