"""Weak-perspective soft renderer: camera transform, lighting, rasterizer,
2x anti-aliasing (port of umr_tpu/renderer/soft_renderer.py).

Reference constants: look_at eye (0,0,-2.732), orthographic, sigma 1e-5,
gamma 1e-4, dist_eps 1e-10, ambient 0.8 (1.0 after ambient_light_only),
directional 0.5 along +y, offset_z 5, anti-aliasing (render at 2x and
average-pool).

Routing (the JAX package's `impl`): under "auto" a CUDA tensor takes the
kernels' autograd Function (ops/raster_kernel.py: forward kernel,
backward kernel with the reference CUDA gradient semantics, on bins that
keep every face a tile reaches, where the JAX package's caps drop some:
ops/raster_bins.py) and a CPU tensor the plain forward (ops/rasterize.py) under
torch autograd, exact AD, as the JAX package's XLA paths. "kernel"
takes the Function on the CPU too (through the kernels' plain versions),
so that CPU tests drive the card's route.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.projection import orthographic_proj_withz
from ..ops.raster_bins import TILE_SIZE, full_raster_bins
from ..ops.raster_kernel import soft_rasterize_fwd
from ..ops.rasterize import RasterOut, soft_rasterize


def surface_normals(face_verts):
    """face_verts [B,F,3,3] -> unit normals [B,F,3],
    normalize(cross(v2 - v1, v0 - v1))."""
    v10 = face_verts[:, :, 0] - face_verts[:, :, 1]
    v12 = face_verts[:, :, 2] - face_verts[:, :, 1]
    n = torch.linalg.cross(v12, v10)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-6)


def apply_lighting(textures, normals, ambient_intensity=0.8,
                   directional_intensity=0.5, light_direction=(0.0, 1.0, 0.0),
                   light_color=(1.0, 1.0, 1.0)):
    """Surface-mode lighting. textures [B,F,T2,3]; normals [B,F,3]."""
    color = textures.new_tensor(light_color)
    direction = textures.new_tensor(light_direction)
    cosine = torch.relu((normals * direction).sum(-1))
    light = ambient_intensity * color + directional_intensity * (
        color * cosine[..., None])
    return textures * light[:, :, None, :]


@dataclasses.dataclass(frozen=True)
class SoftRenderer:
    """cams are 7-vectors [scale, tx, ty, qw, qx, qy, qz]."""

    image_size: int = 256
    render_type: str = "softmax"          # aggr_func_rgb: softmax | hard
    background_color: tuple = (0.0, 0.0, 0.0)
    sigma_val: float = 1e-5
    gamma_val: float = 1e-4
    dist_eps: float = 1e-10
    anti_aliasing: bool = True
    ambient_intensity: float = 0.8
    directional_intensity: float = 0.5
    light_direction: tuple = (0.0, 1.0, 0.0)
    light_color: tuple = (1.0, 1.0, 1.0)
    eye: tuple = (0.0, 0.0, -2.732)
    offset_z: float = 5.0
    impl: str = "auto"                    # auto | kernel (see module doc)
    face_chunk: int = 160                 # the plain route's face chunk

    def ambient_light_only(self):
        return dataclasses.replace(self, ambient_intensity=1.0,
                                   directional_intensity=0.0)

    @property
    def render_size(self):
        return self.image_size * (2 if self.anti_aliasing else 1)

    def uses_kernel(self, device):
        """Whether renders on `device` take the kernels' route."""
        if self.impl not in ("auto", "kernel"):
            raise ValueError(f"impl={self.impl!r}")
        return torch.device(device).type == "cuda" or self.impl == "kernel"

    def resolved_mf_cap(self, num_faces):
        """The JAX package's per-tile face cap for these renders, for the
        tools that hold the kernels to its capped layout (the renders
        themselves cap nothing): per-tile face density scales with F *
        ts^2 / S^2 (x32 for 2x headroom), floor 256, ceiling 1024, at most
        F, then rounded up to a multiple of 32."""
        S = self.render_size
        cap = -(-32 * num_faces * TILE_SIZE * TILE_SIZE // (S * S))
        cap = min(num_faces, min(max(256, cap), 1024))
        return -(-cap // 32) * 32

    def project_points(self, verts, cams):
        """[B,N,3], [B,7] -> [B,N,2]."""
        return orthographic_proj_withz(verts, cams)[:, :, :2]

    def project_faces(self, vertices, faces, cams):
        """verts [B,V,3], faces [F,3] int, cams [B,7] -> [B,F,3,3] in the
        rasterizer's frame (y flipped, eye offset)."""
        verts = orthographic_proj_withz(vertices, cams, offset_z=self.offset_z)
        # y flip into image coords; look_at with the eye on -z is a z offset
        verts = verts * verts.new_tensor([1.0, -1.0, 1.0])
        verts = verts - verts.new_tensor(self.eye)
        return verts[:, faces.long()]

    def compute_bins(self, vertices, faces, cams):
        """The face -> tile bins that render() walks on the kernels' route
        (ops/raster_bins.py::full_raster_bins: every face a tile reaches),
        for a caller that shares them between renders of the same
        projected geometry; valid for any renderer that agrees on
        image_size, anti_aliasing, sigma_val, dist_eps, eye and
        offset_z."""
        fv = self.project_faces(vertices.detach(), faces, cams.detach())
        return full_raster_bins(fv, self.render_size, self.sigma_val,
                                self.dist_eps)

    def render(self, vertices, faces, cams, textures=None, mask_only=False,
               rgb_geom_detach=False, tex_grads=True, bins=None,
               need_p2f=False):
        """vertices [B,V,3]; faces [F,3]; cams [B,7]; textures [B,F,T2,3]
        or None. Returns RasterOut with rgba [B,H,W,4] at image_size; its
        p2f [B,F,2] (need_p2f, softmax; zeros otherwise) is taken at
        render_size, before the anti-aliasing pool, and carries no
        gradient on the kernels' route.

        mask_only, rgb_geom_detach, tex_grads and bins act on the kernels'
        route (ops/raster_kernel.py::soft_rasterize_fwd, which bins the
        faces itself when bins is None); the plain route
        renders every face in chunks of face_chunk and differentiates
        exactly, and reads mask_only and need_p2f only."""
        fv = self.project_faces(vertices, faces, cams).contiguous()
        identity_light = (self.ambient_intensity == 1.0
                          and self.directional_intensity == 0.0
                          and tuple(self.light_color) == (1.0, 1.0, 1.0))
        if textures is not None and not identity_light:
            textures = apply_lighting(
                textures, surface_normals(fv), self.ambient_intensity,
                self.directional_intensity, self.light_direction,
                self.light_color)
        if textures is not None:
            textures = textures.contiguous()
        kw = dict(image_size=self.render_size,
                  background_color=tuple(self.background_color),
                  sigma_val=self.sigma_val, dist_eps=self.dist_eps,
                  gamma_val=self.gamma_val, aggr_func_rgb=self.render_type,
                  mask_only=mask_only, need_p2f=need_p2f)
        if self.uses_kernel(fv.device):
            out = soft_rasterize_fwd(
                fv, textures, rgb_geom_detach=rgb_geom_detach,
                tex_grads=tex_grads, bins=bins, **kw)
        else:
            out = soft_rasterize(fv, textures, face_chunk=self.face_chunk,
                                 **kw)
        if self.anti_aliasing:
            B, C = out.rgba.shape[0], out.rgba.shape[-1]
            S = self.image_size
            rgba = out.rgba.reshape(B, S, 2, S, 2, C).mean(dim=(2, 4))
            out = RasterOut(rgba=rgba, p2f=out.p2f, aggr=out.aggr)
        return out
