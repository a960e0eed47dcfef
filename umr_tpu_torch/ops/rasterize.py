"""Dense soft rasterizer in plain torch: the CUDA kernel's plain version.

Port of the forward of umr_tpu/ops/rasterize.py::soft_rasterize, for the
subset the renderer uses: euclidean distance, product alpha, softmax or
hard RGB, surface textures. Every (pixel, face) pair is evaluated, chunked
over faces and pixel rows, with no binning and no per-tile cap, so holding
the binned kernel (ops/raster_kernel.py) against it also checks the bins.

The per-pair arithmetic is written as the TPU kernel writes it
(umr_tpu/ops/raster_kernel.py::_pair_math: reciprocals hoisted per face,
the clamped foot point as a delta), one rounding per operation. The CUDA
kernel evaluates the same expressions in the same order without FMA
contraction, so barycentrics, depths and texel indices agree bit for bit
and the two differ only in the order of the softmax and alpha sums.

Pixel convention: pixel (row i, col j) sits at xp = (2j+1-S)/S,
yp = (2(S-1-i)+1-S)/S; callers pass face vertices with y already negated.

p2f, the per-face expected image coordinate (need_p2f, softmax only):
sum over pixels of contrib * (gx, gy) / sum of contrib, on the grid
gx = 2j/(S-1) - 1, gy = 2i/(S-1) - 1, as umr_tpu/ops/rasterize.py
computes it: a pair's contrib is its softmax weight against the pixel's
running max after the pair's face chunk. So the rule depends on the
chunking: at face_chunk=1 the max is the running max after this face,
the reference CUDA kernel's rule, which the CUDA kernel follows and
tests/golden_raster.py encodes; at face_chunk=F it is the pixel's final
max, the JAX package's dense rule. With gamma 1e-4 the two differ
wherever a face is visited before a nearer one; they agree where depth
is constant over the faces.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_NEG_INF = -1e30
# the reference's rasterizer constants (depth range, softmax background eps)
NEAR, FAR, EPS = 1.0, 100.0, 1e-3
# offscreen dummy face that pads the last face chunk (every cull rejects it)
_DUMMY_FACE = ((10.0, 10.0, 5.0), (10.1, 10.0, 5.0), (10.0, 10.1, 5.0))


class RasterOut(NamedTuple):
    rgba: torch.Tensor   # [B, H, W, 4]
    p2f: torch.Tensor    # [B, F, 2] expected image coordinate per face
                         # (need_p2f, softmax), else zeros
    aggr: torch.Tensor   # [B, 2, H, W]: (softmax_sum, softmax_max) or
                         #               (depth_min, face_index_min) in hard


def normalize_p2f(sums):
    """Per-face sums of contrib * (gx, gy, 1) [..., 3] -> p2f [..., 2]."""
    return sums[..., :2] / sums[..., 2:].clamp_min(1e-12)


def threshold_of(sigma_val, dist_eps):
    """Squared-distance cull threshold and its square root (the bbox
    margin), as the JAX package derives them."""
    thr = float(np.log(1.0 / dist_eps - 1.0)) * sigma_val
    return thr, math.sqrt(thr)


def _face_info(fx, fy, fz):
    """Per-face setup: inverse barycentric rows, per-edge projection
    coefficients, obtuse flags, 1/z and the projection-degenerate cull.
    fx, fy, fz: [B, Fc, 3] -> dict of [B, Fc, 1] tensors (lists of them)."""
    xs = [fx[..., k, None] for k in range(3)]
    ys = [fy[..., k, None] for k in range(3)]
    x0, x1, x2 = xs
    y0, y1, y2 = ys
    det = x2 * (y0 - y1) + x0 * (y1 - y2) + x1 * (y2 - y0)
    nondegen = det.abs() > 1e-10
    det = torch.where(det > 0, det.clamp_min(1e-10), det.clamp_max(-1e-10))
    rdet = 1.0 / det
    star = [y1 - y2, x2 - x1, x1 * y2 - x2 * y1,
            y2 - y0, x0 - x2, x2 * y0 - x0 * y2,
            y0 - y1, x1 - x0, x0 * y1 - x1 * y0]
    sym = [[xs[i] * xs[j] + ys[i] * ys[j] + 1.0 for j in range(3)]
           for i in range(3)]
    edges = []
    for k in range(3):
        v0, v1 = k, (k + 1) % 3
        a0 = [sym[v0][j] - sym[v1][j] for j in range(3)]
        denom = a0[v0] - a0[v1]
        denom = torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
        edges.append((a0, 1.0 / denom))
    obt = []
    for k in range(3):
        k1, k2 = (k + 1) % 3, (k + 2) % 3
        obt.append((xs[k1] - xs[k]) * (xs[k2] - xs[k])
                   + (ys[k1] - ys[k]) * (ys[k2] - ys[k]) < 0)
    return dict(
        xs=xs, ys=ys, rz=[1.0 / fz[..., k, None] for k in range(3)],
        inv=[sv * rdet for sv in star], edges=edges, obt=obt,
        nondegen=nondegen,
        bbox=(fx.amax(-1)[..., None], fx.amin(-1)[..., None],
              fy.amax(-1)[..., None], fy.amin(-1)[..., None]),
    )


def _euclidean(w, fi, xp, yp, foot=False):
    """Signed euclidean pixel-to-triangle distance components.

    w: 3 x [B,Fc,P]; fi: _face_info. Returns (inside, dis_x, dis_y), and
    with foot=True also the selected foot point's weights minus w
    (3 x [B,Fc,P]), which the backward's vertex gradient reads."""
    xs, ys = fi["xs"], fi["ys"]
    dxu, dyu, dxc, dyc, du, tus, tcs = [], [], [], [], [], [], []
    for k, (a0, rden) in enumerate(fi["edges"]):
        v0, v1, v2 = k, (k + 1) % 3, (k + 2) % 3
        tv0 = (w[0] * a0[0] + w[1] * a0[1] + w[2] * a0[2] - a0[v1]) * rden
        t = [None, None, None]
        t[v0], t[v1], t[v2] = tv0, 1.0 - tv0, torch.zeros_like(tv0)
        tu = [t[j] - w[j] for j in range(3)]
        dx = tu[0] * xs[0] + tu[1] * xs[1] + tu[2] * xs[2]
        dy = tu[0] * ys[0] + tu[1] * ys[1] + tu[2] * ys[2]
        # clamped foot point: only the v0/v1 weights move, by +-delta
        delta = tv0.clamp(0.0, 1.0) - tv0
        dxu.append(dx)
        dyu.append(dy)
        du.append(dx * dx + dy * dy)
        dxc.append(dx + delta * (xs[v0] - xs[v1]))
        dyc.append(dy + delta * (ys[v0] - ys[v1]))
        if foot:
            tc = list(tu)
            tc[v0] = tu[v0] + delta
            tc[v1] = tu[v1] - delta
            tus.append(tu)
            tcs.append(tc)

    # nearest edge when inside (first minimum on ties)
    k_in = torch.where(du[1] < du[0], 1, 0)
    k_in = torch.where(du[2] < torch.minimum(du[0], du[1]), 2, k_in)

    # outside: the edge selection cascade of the reference kernel
    n0, n1, n2 = w[0] <= 0, w[1] <= 0, w[2] <= 0
    obt = fi["obt"]

    def corner_dot(k, kk):
        return ((xp - xs[k]) * (xs[kk] - xs[k])
                + (yp - ys[k]) * (ys[kk] - ys[k]))

    vA = torch.where(obt[0] & (corner_dot(0, 2) > 0), 2, 0)
    vB = torch.where(obt[1] & (corner_dot(1, 0) > 0), 0, 1)
    vC = torch.where(obt[2] & (corner_dot(2, 1) > 0), 1, 2)
    caseA = n1 & n2
    caseB = n2 & n0 & ~caseA
    caseC = n0 & n1 & ~caseA & ~caseB
    v_single = torch.where(n0, 1, torch.where(n1, 2, 0))
    v_out = torch.where(caseA, vA, torch.where(
        caseB, vB, torch.where(caseC, vC, v_single)))

    def pick(vals, k):
        return torch.where(k == 0, vals[0],
                           torch.where(k == 1, vals[1], vals[2]))

    inside = ((w[0] > 0) & (w[1] > 0) & (w[2] > 0)
              & (w[0] < 1) & (w[1] < 1) & (w[2] < 1))
    dis_x = torch.where(inside, pick(dxu, k_in), pick(dxc, v_out))
    dis_y = torch.where(inside, pick(dyu, k_in), pick(dyc, v_out))
    if not foot:
        return inside, dis_x, dis_y
    t_sel = [torch.where(inside, pick([tu[j] for tu in tus], k_in),
                         pick([tc[j] for tc in tcs], v_out))
             for j in range(3)]
    return inside, dis_x, dis_y, t_sel


def face_chunks(face_vertices, textures, face_chunk):
    """Per-face setup of [B, F, 3, 3] faces in chunks of face_chunk, the
    last chunk padded with the offscreen dummy face. A list of
    _face_info dicts, each with 'ok' (kept faces, [B,Fc,1]), 'tex' (their
    texel sheets) and 'base' (the chunk's first face id)."""
    B, F = face_vertices.shape[:2]
    dtype, device = face_vertices.dtype, face_vertices.device
    Fc = min(face_chunk, F)
    n_chunks = -(-F // Fc)
    F_pad = n_chunks * Fc
    fv, tex = face_vertices, textures
    if F_pad != F:
        dummy = torch.tensor(_DUMMY_FACE, dtype=dtype, device=device)
        fv = torch.cat([fv, dummy.expand(B, F_pad - F, 3, 3)], dim=1)
        tex = torch.cat(
            [tex, tex.new_zeros((B, F_pad - F) + tuple(tex.shape[2:]))], 1)
    face_valid = torch.arange(F_pad, device=device) < F
    chunks = []
    for ci in range(n_chunks):
        sl = slice(ci * Fc, (ci + 1) * Fc)
        fi = _face_info(fv[:, sl, :, 0], fv[:, sl, :, 1], fv[:, sl, :, 2])
        fi["ok"] = fi.pop("nondegen") & face_valid[None, sl, None]
        fi["tex"] = tex[:, sl]
        fi["base"] = ci * Fc
        chunks.append(fi)
    return chunks


def pixel_block(S, pixel_rows_per_block):
    """(rows per block, pixels per block) of an S x S image."""
    rows_blk = min(pixel_rows_per_block, S)
    if S % rows_blk:
        raise ValueError("image_size must be divisible by pixel_rows_per_block")
    return rows_blk, rows_blk * S


def pixel_coords(S, r0, rows, dtype, device):
    """NDC centres (xp, yp), [1, 1, rows * S] each, of pixel rows
    r0 .. r0 + rows - 1."""
    ar = torch.arange(S, dtype=dtype, device=device)
    xp = (2.0 * ar + 1.0 - S) / S
    yp = (2.0 * (S - 1 - ar) + 1.0 - S) / S
    return (xp.repeat(rows)[None, None, :],
            yp[r0:r0 + rows].repeat_interleave(S)[None, None, :])


def grid_coords(S, r0, rows, dtype, device):
    """p2f grid coordinates (gx, gy), [rows * S] each, of pixel rows
    r0 .. r0 + rows - 1, as the CUDA kernel computes them."""
    ar = torch.arange(S, dtype=dtype, device=device)
    g = 2.0 * ar / (S - 1) - 1.0
    return g.repeat(rows), g[r0:r0 + rows].repeat_interleave(S)


def pair_math(ch, xp, yp, threshold, margin, inv_sigma, foot=False):
    """Everything a (pixel, face) pair computes that does not depend on
    the other faces, for one face chunk `ch` (face_chunks) and pixels
    (xp, yp): a dict of [B,Fc,P] tensors (lists of 3 for w, wc and, with
    foot=True, t). `valid` is the bbox/threshold/degenerate cull; `frag`
    is zero where it fails."""
    maxx, minx, maxy, miny = ch["bbox"]
    out_border = ((xp > maxx + margin) | (xp < minx - margin)
                  | (yp > maxy + margin) | (yp < miny - margin))
    valid = ~out_border & ch["ok"]
    inv = ch["inv"]
    w = [inv[3 * k] * xp + inv[3 * k + 1] * yp + inv[3 * k + 2]
         for k in range(3)]
    inside, dis_x, dis_y, *t = _euclidean(w, ch, xp, yp, foot=foot)
    sign = torch.where(inside, 1.0, -1.0)
    dis = dis_x * dis_x + dis_y * dis_y
    valid = valid & ~((sign < 0) & (dis >= threshold))
    frag = torch.sigmoid(sign * dis * inv_sigma) * valid

    wc = [a.clamp(1e-5, 1.0 - 1e-5) for a in w]
    rws = 1.0 / (wc[0] + wc[1] + wc[2]).clamp_min(1e-5)
    wc = [a * rws for a in wc]
    rz = ch["rz"]
    zp = 1.0 / (wc[0] * rz[0] + wc[1] * rz[1] + wc[2] * rz[2])
    z_ok = (zp >= NEAR) & (zp <= FAR)
    out = dict(w=w, valid=valid, frag=frag, sign=sign, dis_x=dis_x,
               dis_y=dis_y, wc=wc, zp=zp, z_ok=z_ok)
    if foot:
        out["t"] = t[0]
    return out


def texel_index(wc, T2):
    """Nearest texel of the per-face texel sheet (surface textures)."""
    R = math.isqrt(T2)
    w_x = torch.floor(wc[0] * R).to(torch.int64)
    w_y = torch.floor(wc[1] * R).to(torch.int64)
    low = (wc[0] + wc[1]) * R - w_x - w_y <= 1
    idx = torch.where(low, w_y * R + w_x, (R - 1 - w_y) * R + (R - 1 - w_x))
    return idx.clamp(0, T2 - 1)


def soft_rasterize(
    face_vertices,
    textures=None,
    image_size=256,
    background_color=(0.0, 0.0, 0.0),
    sigma_val=1e-5,
    dist_eps=1e-4,
    gamma_val=1e-4,
    aggr_func_rgb="softmax",
    mask_only=False,
    face_chunk=160,
    pixel_rows_per_block=32,
    need_p2f=False,
):
    """Rasterize projected triangles into RGBA, p2f and aggr, densely,
    with faces shaded from both sides (the renderer's double_side=True).

    face_vertices: [B, F, 3, 3] (x, y, z) per corner; textures:
    [B, F, T2, 3] surface texel sheets or None (constant white).
    mask_only (softmax only) skips the colours: rgb is the background.
    face_chunk and pixel_rows_per_block bound the [B, chunk, rows * S]
    temporaries (memory); the result depends on them only through the
    order of the sums, and p2f through face_chunk (see the module doc).
    need_p2f computes p2f (softmax; zeros otherwise).
    """
    if aggr_func_rgb not in ("softmax", "hard"):
        raise ValueError(f"aggr_func_rgb={aggr_func_rgb!r}")
    hard = aggr_func_rgb == "hard"
    mask_only = mask_only and not hard
    B, F = face_vertices.shape[:2]
    S = int(image_size)
    dtype, device = face_vertices.dtype, face_vertices.device
    if textures is None:
        textures = torch.ones((B, F, 1, 3), dtype=dtype, device=device)
    T2 = textures.shape[2]
    threshold, margin = threshold_of(sigma_val, dist_eps)

    chunks = face_chunks(face_vertices, textures, face_chunk)
    rows_blk, P = pixel_block(S, pixel_rows_per_block)

    bg = list(background_color)[:3] + [0.0] * (3 - len(background_color))
    bg = torch.tensor(bg, dtype=dtype, device=device)
    bg_weight = float(np.exp(EPS / gamma_val))
    inv_sigma = 1.0 / sigma_val
    inv_gamma = 1.0 / gamma_val
    inv_depth_range = 1.0 / (FAR - NEAR)

    need_p2f = need_p2f and not hard
    # per-face sums of contrib * (gx, gy, 1), padded faces included; p2f
    # is read detached, so it is summed outside autograd
    p2f_sums = (face_vertices.new_zeros((B, F + face_chunk, 3)) if need_p2f
                else None)
    rgba_rows, aggr_rows = [], []
    for r0 in range(0, S, rows_blk):
        xp, yp = pixel_coords(S, r0, rows_blk, dtype, device)
        if need_p2f:
            gx, gy = grid_coords(S, r0, rows_blk, dtype, device)
        alpha_acc = face_vertices.new_ones((B, P))
        if hard:
            depth = face_vertices.new_full((B, P), 1e7)
            fid = torch.full((B, P), -1, dtype=torch.int64, device=device)
            color_acc = bg.expand(B, P, 3).clone()
        else:
            m = face_vertices.new_full((B, P), EPS)
            s = face_vertices.new_full((B, P), bg_weight)
            color_acc = bg.expand(B, P, 3) * bg_weight
        for ch in chunks:
            pm = pair_math(ch, xp, yp, threshold, margin, inv_sigma)
            w, valid, frag, wc, zp, z_ok = (
                pm[k] for k in ("w", "valid", "frag", "wc", "zp", "z_ok"))
            alpha_acc = alpha_acc * torch.prod(1.0 - frag, dim=1)
            if not mask_only:
                idx = texel_index(wc, T2)                          # [B,Fc,P]
                color = torch.gather(
                    ch["tex"], 2, idx[..., None].expand(-1, -1, -1, 3))

            if hard:
                inside01 = ((w[0] >= 0) & (w[0] <= 1) & (w[1] >= 0)
                            & (w[1] <= 1) & (w[2] >= 0) & (w[2] <= 1))
                cand = valid & z_ok & inside01
                zp_c = torch.where(cand, zp, torch.inf)
                best = zp_c.argmin(dim=1)      # first minimum: lowest id
                best_z = zp_c.gather(1, best[:, None])[:, 0]
                best_color = torch.gather(
                    color, 1, best[:, None, :, None].expand(-1, 1, -1, 3))[:, 0]
                improved = best_z < depth
                depth = torch.where(improved, best_z, depth)
                fid = torch.where(improved, best + ch["base"], fid)
                color_acc = torch.where(improved[..., None], best_color,
                                        color_acc)
            else:
                rgb_valid = valid & z_ok
                z_norm = (FAR - zp) * inv_depth_range
                z_masked = torch.where(rgb_valid, z_norm, _NEG_INF)
                m_new = torch.maximum(m, z_masked.amax(dim=1))
                scale = torch.exp((m - m_new) * inv_gamma)
                contrib = torch.exp((z_masked - m_new[:, None]) * inv_gamma) * frag
                s = s * scale + contrib.sum(dim=1)
                if not mask_only:
                    color_acc = color_acc * scale[..., None] + torch.einsum(
                        "bfp,bfpc->bpc", contrib, color)
                m = m_new
                if need_p2f:
                    c = contrib.detach()
                    p2f_sums[:, ch["base"]:ch["base"] + c.shape[1]] += (
                        torch.stack([c @ gx, c @ gy, c.sum(2)], -1))

        alpha = 1.0 - alpha_acc
        if hard:
            rgb = torch.where((fid >= 0)[..., None], color_acc, bg)
            aggr = torch.stack([depth, fid.to(dtype)], dim=1)
        else:
            rgb = bg.expand(B, P, 3) if mask_only else color_acc / s[..., None]
            aggr = torch.stack([s, m], dim=1)
        rgba_rows.append(torch.cat([rgb, alpha[..., None]], -1)
                         .reshape(B, rows_blk, S, 4))
        aggr_rows.append(aggr.reshape(B, 2, rows_blk, S))

    p2f = (normalize_p2f(p2f_sums[:, :F]) if need_p2f
           else face_vertices.new_zeros((B, F, 2)))
    return RasterOut(rgba=torch.cat(rgba_rows, 1), p2f=p2f,
                     aggr=torch.cat(aggr_rows, 2))
