"""Wavefront .obj export, with a baked per-face texture atlas or per-vertex
colours, and the .obj reader (copies of umr_tpu/utils/obj_io.py::save_obj
and load_obj, so that the port never imports the JAX package; the atlas
PNG goes through png.py, not imageio; tests/test_torch_host.py pins the
written files and the read arrays equal to the JAX package's)."""

from __future__ import annotations

import os

import numpy as np

from .png import write_png


def bake_texture_atlas(textures, texture_res=16):
    """[F,T2,3] per-face texels -> (atlas image [H,W,3], per-face-corner
    UVs [F,3,2]): faces tiled into a square grid of triangles, each tile
    filled from barycentric texel lookups."""
    F, T2, _ = textures.shape
    R = int(np.sqrt(T2))
    tile = texture_res
    cols = int(np.ceil(np.sqrt(F)))
    rowsn = int(np.ceil(F / cols))
    H, W = rowsn * tile, cols * tile
    atlas = np.zeros((H, W, 3), np.float32)

    ys, xs = np.mgrid[0:tile, 0:tile]
    w0c = np.clip(xs / max(tile - 1, 1), 1e-5, 1 - 1e-5)
    w1c = np.clip(ys / max(tile - 1, 1), 1e-5, 1 - 1e-5)
    w_x = np.clip((w0c * R).astype(int), 0, R - 1)
    w_y = np.clip((w1c * R).astype(int), 0, R - 1)
    low = (w0c + w1c) * R - w_x - w_y <= 1
    idx = np.where(low, w_y * R + w_x, (R - 1 - w_y) * R + (R - 1 - w_x))
    idx = np.clip(idx, 0, R * R - 1)

    uvs = np.zeros((F, 3, 2), np.float32)
    for f in range(F):
        r, c = divmod(f, cols)
        atlas[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = (
            textures[f][idx])
        x0, y0 = c * tile, r * tile
        # face corners at (w0, w1) = (1, 0), (0, 1), (0, 0)
        uvs[f, 0] = [x0 + tile - 1, y0]
        uvs[f, 1] = [x0, y0 + tile - 1]
        uvs[f, 2] = [x0, y0]
    uvs[..., 0] = (uvs[..., 0] + 0.5) / W
    uvs[..., 1] = 1.0 - (uvs[..., 1] + 0.5) / H
    return atlas, uvs


def save_obj(path, vertices, faces, textures=None, texture_res=16,
             texture_type="surface"):
    """vertices [V,3]; faces [F,3] int; textures [F,T2,3] ('surface') or
    [V,3] ('vertex'). Writes {path}, and for surface textures a baked
    {stem}.png atlas and {stem}.mtl."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces, np.int64)
    stem = os.path.splitext(path)[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    surface = textures is not None and texture_type == "surface"
    lines = [f"mtllib {os.path.basename(stem)}.mtl"] if surface else []
    if textures is not None and texture_type == "vertex":
        lines += ["v %f %f %f %f %f %f" % (v[0], v[1], v[2], c[0], c[1], c[2])
                  for v, c in zip(vertices, np.asarray(textures))]
    else:
        lines += ["v %f %f %f" % (v[0], v[1], v[2]) for v in vertices]
    if surface:
        atlas, uvs = bake_texture_atlas(np.asarray(textures), texture_res)
        write_png(stem + ".png", (np.clip(atlas, 0, 1) * 255).astype(np.uint8))
        with open(stem + ".mtl", "w") as f:
            f.write("newmtl material_1\nmap_Kd %s.png\n"
                    % os.path.basename(stem))
        lines += ["vt %f %f" % (uv[0], uv[1]) for uv in uvs.reshape(-1, 2)]
        lines.append("usemtl material_1")
        for i, face in enumerate(faces):
            lines.append("f %d/%d %d/%d %d/%d"
                         % (face[0] + 1, 3 * i + 1, face[1] + 1, 3 * i + 2,
                            face[2] + 1, 3 * i + 3))
    else:
        lines += ["f %d %d %d" % (f[0] + 1, f[1] + 1, f[2] + 1) for f in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_obj(path, normalization=False, load_texture=False, texture_res=4):
    """Load vertices/faces (+ optional vertex-uv texture sampling from the
    atlas) — numpy port of functional/load_obj.py."""
    vertices, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                faces.append(idx)
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    if normalization:
        vertices = vertices - vertices.mean(0)
        vertices = vertices / np.abs(vertices).max()
    return vertices, faces
