"""Weak-perspective soft renderer: camera transform, lighting, rasterizer,
2x anti-aliasing (port of umr_tpu/renderer/soft_renderer.py).

Reference constants: look_at eye (0,0,-2.732), orthographic, sigma 1e-5,
gamma 1e-4, dist_eps 1e-10, ambient 0.8, directional 0.5 along +y,
offset_z 5, anti-aliasing (render at 2x and average-pool).

On a CUDA tensor the rasterizer is the CUDA kernel (ops/raster_kernel.py);
on a CPU tensor it is the kernel's plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.projection import orthographic_proj_withz
from ..ops.raster_kernel import TILE_SIZE, soft_rasterize_fwd
from ..ops.rasterize import RasterOut


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

    @property
    def render_size(self):
        return self.image_size * (2 if self.anti_aliasing else 1)

    def resolved_mf_cap(self, num_faces):
        """The kernel's per-tile face cap, sized as the JAX package sizes
        its kernel's: per-tile face density scales with F * ts^2 / S^2
        (x32 for 2x headroom), floor 256, ceiling 1024, at most F, then
        rounded up to a multiple of 32."""
        S = self.render_size
        cap = -(-32 * num_faces * TILE_SIZE * TILE_SIZE // (S * S))
        cap = min(num_faces, min(max(256, cap), 1024))
        return -(-cap // 32) * 32

    def project_faces(self, vertices, faces, cams):
        """verts [B,V,3], faces [F,3] int, cams [B,7] -> [B,F,3,3] in the
        rasterizer's frame (y flipped, eye offset)."""
        verts = orthographic_proj_withz(vertices, cams, offset_z=self.offset_z)
        # y flip into image coords; look_at with the eye on -z is a z offset
        verts = verts * verts.new_tensor([1.0, -1.0, 1.0])
        verts = verts - verts.new_tensor(self.eye)
        return verts[:, faces.long()]

    def render(self, vertices, faces, cams, textures=None):
        """vertices [B,V,3]; faces [F,3]; cams [B,7]; textures [B,F,T2,3]
        or None. Returns RasterOut with rgba [B,H,W,4] at image_size."""
        fv = self.project_faces(vertices, faces, cams).contiguous()
        if textures is not None:
            textures = apply_lighting(
                textures, surface_normals(fv), self.ambient_intensity,
                self.directional_intensity, self.light_direction,
                self.light_color).contiguous()
        out = soft_rasterize_fwd(
            fv, textures, image_size=self.render_size,
            background_color=tuple(self.background_color),
            sigma_val=self.sigma_val, dist_eps=self.dist_eps,
            gamma_val=self.gamma_val, aggr_func_rgb=self.render_type,
            mf_cap=self.resolved_mf_cap(fv.shape[1]))
        if self.anti_aliasing:
            B, C = out.rgba.shape[0], out.rgba.shape[-1]
            S = self.image_size
            rgba = out.rgba.reshape(B, S, 2, S, 2, C).mean(dim=(2, 4))
            out = RasterOut(rgba=rgba, p2f=out.p2f, aggr=out.aggr)
        return out
