"""Ray/triangle geometry utilities on the host, in numpy (copy of
umr_tpu/utils/geometry.py, so that the port never imports the JAX
package; tests/test_torch_host.py pins it equal): ray-triangle
intersection and projecting query points onto a mesh along a direction.
Not on the training path.
"""

from __future__ import annotations

import numpy as np


def ray_triangle_intersect(orig, direction, v0, v1, v2, eps=1e-9):
    """Möller–Trumbore. orig/direction: [3]; returns (hit, t) with t the ray
    parameter (ref: utils/geometry.py:34-60)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(direction, e2)
    det = e1 @ pvec
    if abs(det) < eps:
        return False, 0.0
    inv_det = 1.0 / det
    tvec = orig - v0
    u = (tvec @ pvec) * inv_det
    if u < 0 or u > 1:
        return False, 0.0
    qvec = np.cross(tvec, e1)
    v = (direction @ qvec) * inv_det
    if v < 0 or u + v > 1:
        return False, 0.0
    t = (e2 @ qvec) * inv_det
    return True, float(t)


def project_points_on_mesh(points, verts, faces, direction=(0.0, 0.0, 1.0)):
    """For each query point, cast a ray along `direction` and return the
    nearest mesh intersection (or the point itself if no hit).

    points: [N,3]; verts: [V,3]; faces: [F,3] -> [N,3]
    (ref: utils/geometry.py:62-78).
    """
    points = np.asarray(points, np.float64)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    direction = np.asarray(direction, np.float64)
    out = points.copy()
    tri = verts[faces]  # [F,3,3]
    for i, p in enumerate(points):
        best = None
        for f in range(len(faces)):
            hit, t = ray_triangle_intersect(
                p, direction, tri[f, 0], tri[f, 1], tri[f, 2]
            )
            if hit and (best is None or abs(t) < abs(best)):
                best = t
        if best is not None:
            out[i] = p + best * direction
    return out
