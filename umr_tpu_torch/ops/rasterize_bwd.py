"""Backward of the soft rasterizer in plain torch: the CUDA backward
kernel's plain version (csrc/raster_bwd.cu).

Port of umr_tpu/ops/raster_kernel_bwd.py::_bwd_kernel, which reproduces
the reference CUDA backward (external/SoftRas/.../soft_rasterize_cuda_
kernel.cu:479-656) for the training configuration (euclidean distance,
softmax RGB, product alpha, surface textures, double-sided faces). These
are the reference's gradient semantics, not the exact derivative of the
forward:
  * a face whose interpolated depth is outside [near, far] gets no
    gradient at all, its alpha path included (the CUDA `continue`);
  * dA/dD_f = (1 - A) / max(1 - D_f, 1e-6);
  * the exp argument is masked before the exp, so a culled pair never
    makes inf * 0;
  * rgb_geom_detach: rgb gradients reach texels only (no depth gradient,
    and the rgb term leaves the distance chain);
  * tex_grads=False: zero texel gradients; mask_only: zero rgb cotangent.

Dense over all (pixel, face) pairs, chunked like ops/rasterize.py::
soft_rasterize, and built from the same per-pair arithmetic (pair_math),
so that barycentrics, depths and texel indices round as the forward's.
Pairs the forward culls contribute nothing (the kernel skips them).
"""

from __future__ import annotations

import torch

from .rasterize import (FAR, NEAR, face_chunks, pair_math, pixel_block,
                        pixel_coords, texel_index, threshold_of)


@torch.no_grad()
def soft_rasterize_bwd(
    face_vertices,
    textures,
    rgba,
    aggr,
    g_rgba,
    image_size=256,
    sigma_val=1e-5,
    dist_eps=1e-4,
    gamma_val=1e-4,
    mask_only=False,
    rgb_geom_detach=False,
    tex_grads=True,
    face_chunk=160,
    pixel_rows_per_block=32,
):
    """Gradients of a softmax render with respect to its faces and texels.

    face_vertices [B,F,3,3] and textures [B,F,T2,3] as the forward took
    them; rgba [B,S,S,4] and aggr [B,2,S,S] (softmax sum, max) as it
    returned them; g_rgba [B,S,S,4] the cotangent of rgba. Returns
    (grad_face_vertices [B,F,3,3], grad_textures [B,F,T2,3])."""
    B, F = face_vertices.shape[:2]
    T2 = textures.shape[2]
    S = int(image_size)
    dtype, device = face_vertices.dtype, face_vertices.device
    threshold, margin = threshold_of(sigma_val, dist_eps)
    inv_sigma = 1.0 / sigma_val
    inv_gamma = 1.0 / gamma_val
    inv_depth_range = 1.0 / (FAR - NEAR)
    c_z = 1.0 / gamma_val / (NEAR - FAR)
    want_tex = tex_grads and not mask_only
    want_z = not (mask_only or rgb_geom_detach)

    chunks = face_chunks(face_vertices, textures, face_chunk)
    rows_blk, P = pixel_block(S, pixel_rows_per_block)
    Fc = chunks[0]["tex"].shape[1]
    g_fv = face_vertices.new_zeros((B, len(chunks) * Fc, 3, 3))
    g_tex = face_vertices.new_zeros((B, len(chunks) * Fc, T2, 3))

    def rows(img, r0):                          # [B,rows,S,C] -> C x [B,1,P]
        x = img[:, r0:r0 + rows_blk].reshape(B, 1, P, img.shape[-1])
        return [x[..., c] for c in range(img.shape[-1])]

    for r0 in range(0, S, rows_blk):
        xp, yp = pixel_coords(S, r0, rows_blk, dtype, device)
        g_r, g_g, g_b, g_a = rows(g_rgba, r0)
        rgb_r, rgb_g, rgb_b, alpha = rows(rgba, r0)
        s_tot, m_tot = rows(aggr.permute(0, 2, 3, 1), r0)
        rs_tot = 1.0 / s_tot
        for ch in chunks:
            pm = pair_math(ch, xp, yp, threshold, margin, inv_sigma,
                           foot=True)
            valid, frag, zp, wc = pm["valid"], pm["frag"], pm["zp"], pm["wc"]
            zgate = pm["z_ok"].to(dtype)

            c_grad_xy = g_a * (1.0 - alpha) / (1.0 - frag).clamp_min(1e-6)
            rgb_valid = valid & pm["z_ok"] & (frag > 0)
            rgb_on = rgb_valid.to(dtype)
            z_norm = (FAR - zp) * inv_depth_range
            z_arg = torch.where(rgb_valid, (z_norm - m_tot) * inv_gamma,
                                -1e30)
            ez_over_s = torch.exp(z_arg) * rs_tot
            zp_softmax = frag * ez_over_s * rgb_on
            sl = slice(ch["base"], ch["base"] + Fc)

            if want_tex or want_z:
                idx = texel_index(wc, T2)                       # [B,Fc,P]
            if want_tex:
                val = zp_softmax * zgate
                for c, g_c in enumerate((g_r, g_g, g_b)):
                    g_tex[:, sl, :, c].scatter_add_(2, idx, val * g_c)
            if want_z:
                col = torch.gather(
                    ch["tex"], 2, idx[..., None].expand(-1, -1, -1, 3))
                col = col * rgb_on[..., None]
                dcol = (g_r * (col[..., 0] - rgb_r)
                        + g_g * (col[..., 1] - rgb_g)
                        + g_b * (col[..., 2] - rgb_b))
                c_rgb_over_frag = ez_over_s * rgb_on * dcol
                c_rgb = c_rgb_over_frag * frag
                c_grad_xy = c_grad_xy + c_rgb_over_frag
                c_zz = c_rgb * c_z * zp * zp
                rz = ch["rz"]
                for k in range(3):
                    g_fv[:, sl, k, 2] += torch.where(
                        valid, zgate * c_zz * wc[k] * (rz[k] * rz[k]),
                        0.0).sum(-1)

            c_grad_xy = c_grad_xy * frag * (1.0 - frag) * inv_sigma
            base = 2.0 * pm["sign"] * c_grad_xy * zgate
            for k in range(3):
                tw = pm["t"][k] + pm["w"][k]
                g_fv[:, sl, k, 0] += torch.where(
                    valid, base * tw * pm["dis_x"], 0.0).sum(-1)
                g_fv[:, sl, k, 1] += torch.where(
                    valid, base * tw * pm["dis_y"], 0.0).sum(-1)
    return g_fv[:, :F].contiguous(), g_tex[:, :F].contiguous()
