"""The mesh template on the host, in numpy: icosphere, symmetric vertex and
face order, per-face UV sampler, graph Laplacian and the flatten loss's
edge indices. A frozen copy of umr_tpu_torch/mesh.py, so that the
benchmark's reference derives the template itself and imports nothing of
the program.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    return verts, faces


def create_sphere(n_subdivide=3):
    """Unit icosphere by midpoint subdivision, mirror-symmetric in exact
    floating point. 3 -> 642 verts / 1280 faces. Returns (verts [V,3]
    float64, faces [F,3] int64)."""
    verts, faces = _icosahedron()
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(n_subdivide):
        edge_mid = {}
        new_verts = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = (verts[key[0]] + verts[key[1]]) / 2.0
                edge_mid[key] = len(new_verts)
                new_verts.append(m / np.linalg.norm(m))
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces.extend([[a, ab, ca], [b, bc, ab], [c, ca, bc],
                              [ab, bc, ca]])
        verts = np.asarray(new_verts)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces


def _mirror(verts, axis):
    flip = np.ones(3)
    flip[axis] = -1.0
    return verts * flip


def make_symmetric(verts, faces, axis=0, tol=1e-6):
    """Reorder vertices as [on the plane, right, left] with the left side
    the exact mirror of the right, and faces likewise. Returns (verts,
    faces, num_indept, num_sym, num_indept_faces, num_sym_faces)."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    coord = verts[:, axis]
    center_inds = np.where(np.abs(coord) <= tol)[0]
    right_inds = np.where(coord > tol)[0]
    left_inds = np.where(coord < -tol)[0]
    assert len(left_inds) == len(right_inds), "mesh is not symmetric"

    def key(v):
        return tuple(np.round(v / max(tol, 1e-9)).astype(np.int64))

    left_lookup = {key(verts[i]): i for i in left_inds}
    mirrored = _mirror(verts[right_inds], axis)
    prop_left = np.array([left_lookup[key(m)] for m in mirrored],
                         dtype=np.int64)
    num_indept, num_sym = len(center_inds), len(right_inds)
    new_order = np.concatenate([center_inds, right_inds, prop_left])
    ind_perm = np.empty(len(verts), dtype=np.int64)
    ind_perm[new_order] = np.arange(len(verts))
    new_verts = verts[new_order].copy()
    new_verts[:num_indept, axis] = 0.0
    new_verts[num_indept + num_sym:] = _mirror(
        new_verts[num_indept:num_indept + num_sym], axis)
    new_faces, num_indept_faces, num_sym_faces = make_faces_symmetric(
        new_verts, ind_perm[faces], num_indept, num_sym, axis)
    return (new_verts, new_faces, num_indept, num_sym, num_indept_faces,
            num_sym_faces)


def make_faces_symmetric(verts, faces, num_indept_verts, num_sym_verts,
                         axis=0):
    """Reorder faces as [on the plane, right, left], left_faces[i][j] the
    mirror of right_faces[i][j]."""
    faces = np.asarray(faces, dtype=np.int64)
    v_map = np.arange(verts.shape[0], dtype=np.int64)
    r = np.arange(num_indept_verts, num_indept_verts + num_sym_verts)
    l = r + num_sym_verts
    v_map[r] = l
    v_map[l] = r
    face_lookup = {tuple(sorted(f)): i for i, f in enumerate(faces)}
    done = np.zeros(len(faces), dtype=bool)
    indept_faces, right_faces, left_faces = [], [], []
    for f_id in range(len(faces)):
        if done[f_id]:
            continue
        face_here = faces[f_id]
        sym_face_here = v_map[face_here]
        if sorted(sym_face_here) == sorted(face_here):
            indept_faces.append(face_here)
            done[f_id] = True
            continue
        sym_fid = face_lookup[tuple(sorted(sym_face_here))]
        unique = np.array(sorted(face_here)) != np.array(sorted(sym_face_here))
        if np.all(verts[face_here][unique, axis]
                  < verts[sym_face_here][unique, axis]):
            left_faces.append(face_here)
            right_faces.append(sym_face_here)
        else:
            left_faces.append(sym_face_here)
            right_faces.append(face_here)
        done[f_id] = True
        done[sym_fid] = True
    assert len(indept_faces) + 2 * len(right_faces) == len(faces)
    new_faces = np.vstack([indept_faces, right_faces, left_faces])
    return new_faces, len(indept_faces), len(right_faces)


def compute_laplacian(num_verts, faces):
    """Row-normalised uniform graph Laplacian L = I - A / deg, [V, V]."""
    lap = np.zeros((num_verts, num_verts), dtype=np.float64)
    for a, b in [(0, 1), (1, 2), (2, 0)]:
        lap[faces[:, a], faces[:, b]] = -1
        lap[faces[:, b], faces[:, a]] = -1
    r, c = np.diag_indices(num_verts)
    lap[r, c] = -lap.sum(1)
    lap /= lap[r, c][:, None]
    return lap.astype(np.float32)


def compute_flatten_indices(faces):
    """(v0, v1, v2, v3) per edge for the dihedral flatten loss, [E, 4]:
    candidate edges are each face's (f0, f1) and (f1, f2), as the
    reference enumerates them (edges met only in the (f0, f2) slot are
    skipped); v2, v3 are the opposite vertices of the edge's two faces."""
    faces = np.asarray(faces, dtype=np.int64)
    cand = np.sort(
        np.concatenate([faces[:, 0:2], faces[:, 1:3]], axis=0), axis=1)
    edges = sorted(set(map(tuple, cand)))
    opp = {}
    for face in faces:
        for e1, e2, o in [(0, 1, 2), (0, 2, 1), (1, 2, 0)]:
            key = (min(face[e1], face[e2]), max(face[e1], face[e2]))
            opp.setdefault(key, []).append(face[o])
    out = []
    for v0, v1 in edges:
        others = opp[(v0, v1)]
        assert len(others) == 2, "non-manifold edge"
        out.append((v0, v1, others[0], others[1]))
    return np.asarray(out, dtype=np.int64)


def get_spherical_coords(X):
    """X [N,3] on the unit sphere -> [N,2] (azimuth, inclination) in
    [-1, 1]."""
    rad = np.linalg.norm(X, axis=1)
    theta = np.arccos(X[:, 2] / rad)
    phi = np.arctan2(X[:, 1], X[:, 0])
    return np.stack([((phi + np.pi) / (2 * np.pi)) * 2 - 1,
                     (theta / np.pi) * 2 - 1], 1)


def compute_uvsampler(verts, faces, tex_size=2):
    """Per-face (alpha, beta) grid points over [0,1]^2 mapped to spherical
    UV: [F, T, T, 2]."""
    alpha = np.arange(tex_size, dtype=np.float64) / (tex_size - 1)
    coords = np.stack([p for p in itertools.product(alpha, alpha)])
    vs = verts[faces]
    v0v2 = vs[:, 0] - vs[:, 2]
    v1v2 = vs[:, 1] - vs[:, 2]
    samples = (np.dstack([v0v2, v1v2]).dot(coords.T)
               + vs[:, 2].reshape(-1, 3, 1))
    samples = np.transpose(samples, (0, 2, 1))
    uv = get_spherical_coords(samples.reshape(-1, 3))
    return uv.reshape(-1, tex_size, tex_size, 2)


@dataclasses.dataclass
class MeshTemplate:
    verts: np.ndarray           # [V, 3] symmetric-ordered sphere verts
    faces: np.ndarray           # [F, 3] int, [indept | right | left] order
    num_indept: int
    num_sym: int
    num_indept_faces: int
    num_sym_faces: int
    mean_v_init: np.ndarray     # [num_indept + num_sym, 3] half mean shape
    uv_sampler: np.ndarray      # [F_tex, T, T, 2], F_tex = indept+right faces
    laplacian: np.ndarray       # [V, V] row-normalised graph Laplacian
    flatten_idx: np.ndarray     # [E, 4] (v0, v1, v2, v3) per edge
    axis: int
    tex_size: int

    @property
    def num_verts(self):
        return self.verts.shape[0]

    @property
    def num_faces(self):
        return self.faces.shape[0]

    @property
    def num_output(self):
        """Vertices the shape head predicts (the half mesh)."""
        return self.num_indept + self.num_sym

    @property
    def num_tex_faces(self):
        return self.num_indept_faces + self.num_sym_faces

    def uv_image_size(self):
        """(H, W) of the UV flow image."""
        img_H = int(2 ** np.floor(np.log2(np.sqrt(self.num_tex_faces)
                                          * self.tex_size)))
        return img_H, 2 * img_H


def compute_edges2verts(verts, faces):
    """[E, 4] = (edge v0, edge v1, opposite verts of the 2 adjacent faces).

    Ref: utils/mesh.py:198-213 (full-edge variant, not on the main path).
    """
    edge_dict = {}
    for face in np.asarray(faces, dtype=np.int64):
        for e1, e2, o in [(0, 1, 2), (0, 2, 1), (1, 2, 0)]:
            edge = (min(face[e1], face[e2]), max(face[e1], face[e2]))
            lst = edge_dict.setdefault(edge, [])
            if face[o] not in lst:
                lst.append(face[o])
    return np.stack(
        [np.hstack((e, o)) for e, o in edge_dict.items()]
    )


def build_template(subdivide=3, axis=1, tex_size=6):
    """The symmetric icosphere template with its UV sampler."""
    verts, faces = create_sphere(subdivide)
    (verts, faces, num_indept, num_sym,
     num_indept_faces, num_sym_faces) = make_symmetric(verts, faces, axis)
    uv_sampler = compute_uvsampler(
        verts, faces[:num_indept_faces + num_sym_faces], tex_size=tex_size)
    return MeshTemplate(
        verts=verts.astype(np.float32), faces=faces.astype(np.int32),
        num_indept=num_indept, num_sym=num_sym,
        num_indept_faces=num_indept_faces, num_sym_faces=num_sym_faces,
        mean_v_init=verts[:num_indept + num_sym].astype(np.float32),
        uv_sampler=uv_sampler.astype(np.float32),
        laplacian=compute_laplacian(verts.shape[0], faces),
        flatten_idx=compute_flatten_indices(faces), axis=axis,
        tex_size=tex_size)


def symmetrize_np(V_half, num_sym, axis=0):
    """[num_indept+num_sym, 3] -> full [_, 3] by mirroring the last num_sym."""
    flip = np.ones((1, 3))
    flip[0, axis] = -1
    return np.concatenate([V_half, flip * V_half[-num_sym:]], axis=0)
