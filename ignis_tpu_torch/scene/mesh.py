"""Host-side triangle mesh and the slice's primitive generators.

Copied from ignis_tpu/scene/mesh.py (which cannot be imported without JAX,
through ignis_tpu/__init__.py): the TriMesh class and the rectangle, plane,
triangle, icosphere and uvsphere generators, unchanged. Mesh file loaders
and the other generators are not on the slice. All numpy, runs at scene
build time only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
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
