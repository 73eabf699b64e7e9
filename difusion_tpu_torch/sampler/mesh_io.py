"""Triangle-mesh IO and primitive constructors (numpy; the port's own copy of
difusion_tpu/sampler/mesh_io.py).

Replaces the reference's Pangolin mesh loading (PreprocessMesh.cu:394) and
Open3D primitive generation (dataset/training/simple_shape.py:53-77) without
external geometry dependencies: a minimal OBJ/OFF reader with polygon-fan
triangulation, an OBJ writer, and box/sphere/cylinder constructors.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class TriMesh(NamedTuple):
    vertices: np.ndarray   # (V, 3) f32
    faces: np.ndarray      # (F, 3) int32

    def face_normals(self, normalized: bool = True) -> np.ndarray:
        a = self.vertices[self.faces[:, 0]]
        b = self.vertices[self.faces[:, 1]]
        c = self.vertices[self.faces[:, 2]]
        n = np.cross(b - a, c - a)
        if normalized:
            n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        return n.astype(np.float32)

    def face_areas(self) -> np.ndarray:
        a = self.vertices[self.faces[:, 0]]
        b = self.vertices[self.faces[:, 1]]
        c = self.vertices[self.faces[:, 2]]
        return (0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)).astype(np.float32)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def transformed(self, matrix: np.ndarray) -> "TriMesh":
        v = self.vertices @ matrix[:3, :3].T + matrix[:3, 3]
        return TriMesh(v.astype(np.float32), self.faces)


def load_mesh(path: str) -> TriMesh:
    path = str(path)
    if path.lower().endswith(".off"):
        return _load_off(path)
    return _load_obj(path)


def _load_obj(path: str) -> TriMesh:
    verts, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):     # polygon fan
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def _load_off(path: str) -> TriMesh:
    with open(path, "r", errors="ignore") as f:
        tokens = f.read().split()
    assert tokens[0].startswith("OFF")
    p = 1 if tokens[0] == "OFF" else 0   # "OFF" may be glued to the counts
    nv, nf = int(tokens[p]), int(tokens[p + 1])
    p += 3
    verts = np.asarray(tokens[p:p + nv * 3], np.float32).reshape(nv, 3)
    p += nv * 3
    faces = []
    for _ in range(nf):
        k = int(tokens[p])
        idx = [int(t) for t in tokens[p + 1:p + 1 + k]]
        for j in range(1, k - 1):
            faces.append([idx[0], idx[j], idx[j + 1]])
        p += 1 + k
    return TriMesh(verts, np.asarray(faces, np.int32))


def save_obj(path: str, mesh: TriMesh):
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in mesh.faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------------
# Primitives (outward-wound)
# ---------------------------------------------------------------------------


def make_box(w: float = 1.0, h: float = 1.0, d: float = 1.0) -> TriMesh:
    v = np.array([[x, y, z] for x in (0, w) for y in (0, h) for z in (0, d)],
                 np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, dd in quads:
        faces += [[a, b, c], [a, c, dd]]
    return TriMesh(v, np.asarray(faces, np.int32))


def make_sphere(radius: float = 0.5, resolution: int = 40) -> TriMesh:
    """UV sphere: ``resolution`` stacks x 2*resolution slices."""
    st = resolution
    sl = 2 * resolution
    verts = [[0, 0, radius]]
    for i in range(1, st):
        theta = np.pi * i / st
        for j in range(sl):
            phi = 2 * np.pi * j / sl
            verts.append([radius * np.sin(theta) * np.cos(phi),
                          radius * np.sin(theta) * np.sin(phi),
                          radius * np.cos(theta)])
    verts.append([0, 0, -radius])
    bottom = len(verts) - 1
    faces = []
    for j in range(sl):
        faces.append([0, 1 + j, 1 + (j + 1) % sl])
    for i in range(st - 2):
        r0 = 1 + i * sl
        r1 = 1 + (i + 1) * sl
        for j in range(sl):
            j1 = (j + 1) % sl
            faces.append([r0 + j, r1 + j, r1 + j1])
            faces.append([r0 + j, r1 + j1, r0 + j1])
    r0 = 1 + (st - 2) * sl
    for j in range(sl):
        faces.append([bottom, r0 + (j + 1) % sl, r0 + j])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def make_cylinder(radius: float = 0.5, height: float = 1.0,
                  resolution: int = 60) -> TriMesh:
    n = resolution
    top, bot = height / 2.0, -height / 2.0
    verts = [[0, 0, top], [0, 0, bot]]
    for j in range(n):
        phi = 2 * np.pi * j / n
        verts.append([radius * np.cos(phi), radius * np.sin(phi), top])
    for j in range(n):
        phi = 2 * np.pi * j / n
        verts.append([radius * np.cos(phi), radius * np.sin(phi), bot])
    faces = []
    for j in range(n):
        j1 = (j + 1) % n
        faces.append([0, 2 + j, 2 + j1])                      # top cap
        faces.append([1, 2 + n + j1, 2 + n + j])              # bottom cap
        faces.append([2 + j, 2 + n + j, 2 + n + j1])          # side
        faces.append([2 + j, 2 + n + j1, 2 + j1])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))
