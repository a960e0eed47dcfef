"""The soft rasterizer of the reference, in plain PyTorch under autograd.

The per-pair arithmetic (barycentrics, the signed euclidean distance to
the triangle, the sigmoid coverage, the perspective-correct depth, the
nearest texel) is a frozen copy of the program's ops/rasterize.py, which
follows SoftRas's reference CUDA kernel. What differs is only how pairs
are found: each image is cut into TILE x TILE pixel tiles, and each tile
lists every face whose bbox, widened by the distance margin and by one
pixel, reaches it, with no cap. Pairs outside a face's widened bbox are
culled by the pair arithmetic itself, so a tile's list may hold more
faces than it needs and never fewer. Tiles are evaluated in chunks under
torch.utils.checkpoint, so autograd keeps only each chunk's output.

Gradients are exact derivatives of this forward, with the detachments
by which SoftRas's CUDA backward defines its gradients:
  * the distance to the triangle takes gradients through its nearest
    point's position with that point's weights held fixed (the envelope
    theorem's derivative);
  * the perspective-correct depth takes gradients through each corner's
    1/z only, with the clamped barycentric weights held fixed;
  * the softmax's running maximum carries none (the result does not
    depend on it);
  * rgb_geom_detach: rgb reaches the texels only, alpha the geometry;
  * textures the caller does not differentiate come in detached.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

NEAR, FAR, EPS = 1.0, 100.0, 1e-3
_NEG_INF = -1e30
TILE = 16
PAIR_BUDGET = 1 << 24          # (tile, face, pixel) pairs a chunk evaluates


def threshold_of(sigma_val, dist_eps):
    thr = math.log(1.0 / dist_eps - 1.0) * sigma_val
    return thr, math.sqrt(thr)


def face_info(fx, fy, fz):
    """Per-face set-up of faces [..., K, 3] -> tensors [..., K, 1]."""
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
    return dict(xs=xs, ys=ys, rz=[1.0 / fz[..., k, None] for k in range(3)],
                inv=[sv * rdet for sv in star], edges=edges, obt=obt,
                nondegen=nondegen,
                bbox=(fx.amax(-1)[..., None], fx.amin(-1)[..., None],
                      fy.amax(-1)[..., None], fy.amin(-1)[..., None]))


def _euclidean(w, fi, xp, yp):
    """(inside, dis_x, dis_y): the components of the vector from the pixel
    to its nearest point on the triangle (on the nearest edge when
    inside). Their values are the program's; their gradients are those of
    sum_j T_j x_j - xp with the foot point's weights T held fixed, the
    derivative the envelope theorem gives and SoftRas's backward uses
    (differentiating the barycentric form itself cancels terms of order
    1 / det in float32)."""
    xs, ys = fi["xs"], fi["ys"]
    dxu, dyu, dxc, dyc, du, feet, feet_c = [], [], [], [], [], [], []
    for k, (a0, rden) in enumerate(fi["edges"]):
        v0, v1, v2 = k, (k + 1) % 3, (k + 2) % 3
        tv0 = (w[0] * a0[0] + w[1] * a0[1] + w[2] * a0[2] - a0[v1]) * rden
        t = [None, None, None]
        t[v0], t[v1], t[v2] = tv0, 1.0 - tv0, torch.zeros_like(tv0)
        tu = [t[j] - w[j] for j in range(3)]
        dx = tu[0] * xs[0] + tu[1] * xs[1] + tu[2] * xs[2]
        dy = tu[0] * ys[0] + tu[1] * ys[1] + tu[2] * ys[2]
        delta = tv0.clamp(0.0, 1.0) - tv0
        dxu.append(dx)
        dyu.append(dy)
        du.append(dx * dx + dy * dy)
        dxc.append(dx + delta * (xs[v0] - xs[v1]))
        dyc.append(dy + delta * (ys[v0] - ys[v1]))
        tc = list(t)
        tc[v0], tc[v1] = tv0 + delta, t[v1] - delta
        feet.append(t)
        feet_c.append(tc)

    k_in = torch.where(du[1] < du[0], 1, 0)
    k_in = torch.where(du[2] < torch.minimum(du[0], du[1]), 2, k_in)
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
    foot = [torch.where(inside, pick([f[j] for f in feet], k_in),
                        pick([f[j] for f in feet_c], v_out)).detach()
            for j in range(3)]
    fx = foot[0] * xs[0] + foot[1] * xs[1] + foot[2] * xs[2]
    fy = foot[0] * ys[0] + foot[1] * ys[1] + foot[2] * ys[2]
    dis_x = dis_x.detach() + (fx - fx.detach())
    dis_y = dis_y.detach() + (fy - fy.detach())
    return inside, dis_x, dis_y


def pair_math(fi, ok, xp, yp, threshold, margin, inv_sigma):
    """What a (pixel, face) pair computes alone: a dict of tensors of the
    broadcast of the faces' [..., K, 1] and the pixels' [..., 1, P]."""
    maxx, minx, maxy, miny = fi["bbox"]
    in_box = ~((xp > maxx + margin) | (xp < minx - margin)
               | (yp > maxy + margin) | (yp < miny - margin)) & ok
    inv = fi["inv"]
    w = [inv[3 * k] * xp + inv[3 * k + 1] * yp + inv[3 * k + 2]
         for k in range(3)]
    inside, dis_x, dis_y = _euclidean(w, fi, xp, yp)
    sign = torch.where(inside, 1.0, -1.0)
    dis = dis_x * dis_x + dis_y * dis_y
    valid = in_box & ~((sign < 0) & (dis >= threshold))
    frag = torch.sigmoid(sign * dis * inv_sigma) * valid
    wc = [a.clamp(1e-5, 1.0 - 1e-5) for a in w]
    rws = 1.0 / (wc[0] + wc[1] + wc[2]).clamp_min(1e-5)
    wc = [(a * rws).detach() for a in wc]
    rz = fi["rz"]
    zp = 1.0 / (wc[0] * rz[0] + wc[1] * rz[1] + wc[2] * rz[2])
    z_ok = (zp >= NEAR) & (zp <= FAR)
    return dict(w=w, in_box=in_box, valid=valid, frag=frag, wc=wc, zp=zp,
                z_ok=z_ok)


def texel_index(wc, T2):
    R = math.isqrt(T2)
    w_x = torch.floor(wc[0] * R).to(torch.int64)
    w_y = torch.floor(wc[1] * R).to(torch.int64)
    low = (wc[0] + wc[1]) * R - w_x - w_y <= 1
    idx = torch.where(low, w_y * R + w_x, (R - 1 - w_y) * R + (R - 1 - w_x))
    return idx.clamp(0, T2 - 1)


def tile_pixels(S, tiles, dtype=torch.float32):
    """Tiles [n] -> (xp, yp) [n, 1, P] pixel centres and (gx, gy) [n, P]
    p2f grid coordinates of their TILE x TILE pixels, row-major."""
    TX = S // TILE
    r = torch.arange(TILE, device=tiles.device)
    rows = ((tiles // TX)[:, None] * TILE
            + r.repeat_interleave(TILE)[None]).to(dtype)
    cols = ((tiles % TX)[:, None] * TILE + r.repeat(TILE)[None]).to(dtype)
    xp = (2.0 * cols + 1.0 - S) / S
    yp = (2.0 * (S - 1 - rows) + 1.0 - S) / S
    return (xp[:, None], yp[:, None],
            2.0 * cols / (S - 1) - 1.0, 2.0 * rows / (S - 1) - 1.0)


@torch.no_grad()
def tile_lists(fv, S, margin, images_per_pass=16):
    """fv [B, F, 3, 3] -> (b [N], tile [N], faces [N, K]) for every (image,
    tile) that some face's widened bbox reaches: its faces in ascending id
    order, padded with -1."""
    B, F = fv.shape[:2]
    TX = S // TILE
    dev = fv.device
    x, y = fv[..., 0], fv[..., 1]
    c_lo = torch.floor(((x.amin(-1) - margin) * S + S - 1) / 2) - 1
    c_hi = torch.ceil(((x.amax(-1) + margin) * S + S - 1) / 2) + 1
    r_lo = torch.floor((S - 1 - (y.amax(-1) + margin) * S) / 2) - 1
    r_hi = torch.ceil((S - 1 - (y.amin(-1) - margin) * S) / 2) + 1
    on = (c_hi >= 0) & (c_lo <= S - 1) & (r_hi >= 0) & (r_lo <= S - 1)

    def tile_of(v):
        return torch.div(v.clamp(0, S - 1), TILE,
                         rounding_mode="floor").long()

    tx0, tx1, ty0, ty1 = (tile_of(v) for v in (c_lo, c_hi, r_lo, r_hi))
    ar = torch.arange(TX, device=dev)
    bs, ts, lists = [], [], []
    for b0 in range(0, B, images_per_pass):
        sl = slice(b0, b0 + images_per_pass)
        in_x = (ar >= tx0[sl, :, None]) & (ar <= tx1[sl, :, None])
        in_y = (ar >= ty0[sl, :, None]) & (ar <= ty1[sl, :, None])
        cover = (in_y[..., :, None] & in_x[..., None, :]
                 & on[sl, :, None, None]).reshape(in_x.shape[0], F, TX * TX)
        rank = torch.cumsum(cover.to(torch.int32), dim=1) - 1
        counts = rank[:, -1] + 1                                # [b, T]
        K = max(int(counts.max()), 1)
        bi, fi, ti = torch.nonzero(cover, as_tuple=True)
        lst = torch.full((cover.shape[0], TX * TX, K), -1, dtype=torch.long,
                         device=dev)
        lst[bi, ti, rank[bi, fi, ti].long()] = fi
        nb, nt = torch.nonzero(counts > 0, as_tuple=True)
        bs.append(nb + b0)
        ts.append(nt)
        lists.append((lst[nb, nt], counts[nb, nt]))
    K = max(lst.shape[1] for lst, _ in lists)
    faces = torch.cat([torch.nn.functional.pad(lst, (0, K - lst.shape[1]),
                                               value=-1)
                       for lst, _ in lists])
    counts = torch.cat([c for _, c in lists])
    order = torch.argsort(counts, stable=True)
    return torch.cat(bs)[order], torch.cat(ts)[order], faces[order], \
        counts[order]


def _chunks(counts, P):
    """Slices of the count-sorted groups, each within PAIR_BUDGET pairs at
    its largest count."""
    counts = counts.tolist()
    out, start = [], 0
    while start < len(counts):
        end = start + 1
        while (end < len(counts)
               and (end + 1 - start) * counts[end] * P <= PAIR_BUDGET):
            end += 1
        out.append((start, end, max(counts[end - 1], 1)))
        start = end
    return out


def _soft_tiles(fv, tex, b, t, fl, S, opts):
    """One chunk of softmax tiles: (rgba [n, P, 4], aggr [n, P, 2], p2f
    sums [n, K, 3] or None)."""
    ok = (fl >= 0)[..., None]
    f = fl.clamp_min(0)
    fvc = fv[b[:, None], f]                                    # [n,K,3,3]
    fi = face_info(fvc[..., 0], fvc[..., 1], fvc[..., 2])
    ok = ok & fi["nondegen"]
    xp, yp, gx, gy = tile_pixels(S, t, fv.dtype)
    pm = pair_math(fi, ok, xp, yp, opts["threshold"], opts["margin"],
                   1.0 / opts["sigma_val"])
    frag, zp = pm["frag"], pm["zp"]
    alpha = 1.0 - torch.prod(1.0 - frag, dim=1)
    inv_gamma = 1.0 / opts["gamma_val"]
    z_norm = (FAR - zp) * (1.0 / (FAR - NEAR))
    z_masked = torch.where(pm["valid"] & pm["z_ok"], z_norm, _NEG_INF)
    m = torch.maximum(z_masked.amax(dim=1),
                      torch.full_like(alpha, EPS)).detach()
    if opts["rgb_geom_detach"]:
        z_rgb, frag_rgb = z_masked.detach(), frag.detach()
    else:
        z_rgb, frag_rgb = z_masked, frag
    contrib = torch.exp((z_rgb - m[:, None]) * inv_gamma) * frag_rgb
    bg_w = math.exp(EPS / opts["gamma_val"]) * torch.exp(
        (EPS - m) * inv_gamma)
    s = bg_w + contrib.sum(dim=1)
    bg = fv.new_tensor(opts["bg"])
    if opts["mask_only"]:
        rgb = bg.expand(alpha.shape + (3,))
    else:
        T2 = tex.shape[2]
        texc = tex[b[:, None], f]                              # [n,K,T2,3]
        idx = texel_index(pm["wc"], T2)                        # [n,K,P]
        color = torch.gather(texc, 2, idx[..., None].expand(-1, -1, -1, 3))
        acc = bg * bg_w[..., None] + (contrib[..., None] * color).sum(1)
        rgb = acc / s[..., None]
    p2f = None
    if opts["need_p2f"]:
        with torch.no_grad():
            run_max = torch.maximum(torch.cummax(z_masked, dim=1).values,
                                    torch.full_like(z_masked, EPS))
            c = torch.exp((z_masked - run_max) * inv_gamma) * frag
            p2f = torch.stack([(c * gx[:, None]).sum(-1),
                               (c * gy[:, None]).sum(-1), c.sum(-1)], -1)
    return (torch.cat([rgb, alpha[..., None]], -1),
            torch.stack([s, m], -1), p2f)


@torch.no_grad()
def _hard_tiles(fv, tex, b, t, fl, S, opts):
    """One chunk of hard tiles: (rgba [n, P, 4], aggr [n, P, 2] = depth,
    face id or -1)."""
    ok = (fl >= 0)[..., None]
    f = fl.clamp_min(0)
    fvc = fv[b[:, None], f]
    fi = face_info(fvc[..., 0], fvc[..., 1], fvc[..., 2])
    ok = ok & fi["nondegen"]
    xp, yp, _, _ = tile_pixels(S, t, fv.dtype)
    pm = pair_math(fi, ok, xp, yp, opts["threshold"], opts["margin"],
                   1.0 / opts["sigma_val"])
    w = pm["w"]
    inside01 = ((w[0] >= 0) & (w[0] <= 1) & (w[1] >= 0) & (w[1] <= 1)
                & (w[2] >= 0) & (w[2] <= 1))
    cand = pm["valid"] & pm["z_ok"] & inside01
    zp = torch.where(cand, pm["zp"], torch.inf)
    best = zp.argmin(dim=1)                                    # [n,P]
    best_z = zp.gather(1, best[:, None])[:, 0]
    hit = torch.isfinite(best_z)
    fid = torch.where(hit, fl.gather(1, best), -1)
    alpha = 1.0 - torch.prod(1.0 - pm["frag"], dim=1)
    bg = fv.new_tensor(opts["bg"])
    T2 = tex.shape[2]
    idx = texel_index(pm["wc"], T2).gather(1, best[:, None])[:, 0]
    color = tex[b[:, None], fl.gather(1, best).clamp_min(0)].gather(
        2, idx[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    rgb = torch.where(hit[..., None], color, bg)
    depth = torch.where(hit, best_z, torch.full_like(best_z, 1e7))
    return (torch.cat([rgb, alpha[..., None]], -1),
            torch.stack([depth, fid.to(fv.dtype)], -1), None)


def rasterize(fv, tex=None, image_size=512, background_color=(0.0, 0.0, 0.0),
              sigma_val=1e-5, dist_eps=1e-10, gamma_val=1e-4, hard=False,
              mask_only=False, rgb_geom_detach=False, need_p2f=False):
    """Faces fv [B, F, 3, 3] (rasterizer frame), textures [B, F, T2, 3] or
    None (white) -> (rgba [B, S, S, 4], aggr [B, 2, S, S], p2f [B, F, 2]
    or None)."""
    B, F = fv.shape[:2]
    S = int(image_size)
    if S % TILE:
        raise ValueError(f"image size {S} is not a multiple of {TILE}")
    if tex is None:
        tex = fv.new_ones((B, F, 1, 3))
    threshold, margin = threshold_of(sigma_val, dist_eps)
    opts = dict(threshold=threshold, margin=margin, sigma_val=sigma_val,
                gamma_val=gamma_val, bg=tuple(background_color)[:3],
                mask_only=mask_only and not hard,
                rgb_geom_detach=rgb_geom_detach,
                need_p2f=need_p2f and not hard)
    b, t, lists, counts = tile_lists(fv.detach(), S, margin)
    P = TILE * TILE
    TX = S // TILE
    fn = _hard_tiles if hard else _soft_tiles
    outs, aggrs, p2f_sums = [], [], None
    if opts["need_p2f"]:
        p2f_sums = fv.new_zeros((B * F, 3))
    for lo, hi, K in _chunks(counts, P):
        args = (b[lo:hi], t[lo:hi], lists[lo:hi, :K])
        if hard or not (fv.requires_grad or tex.requires_grad):
            rgba, aggr, p2f = fn(fv, tex, *args, S, opts)
        else:
            rgba, aggr, p2f = checkpoint(fn, fv, tex, *args, S, opts,
                                         use_reentrant=False)
        outs.append(rgba)
        aggrs.append(aggr.detach())
        if p2f is not None:
            ids = (args[0][:, None] * F + args[2].clamp_min(0)).reshape(-1)
            keep = (args[2] >= 0).reshape(-1)
            p2f_sums.index_add_(0, ids[keep], p2f.reshape(-1, 3)[keep])

    bg = list(background_color)[:3]
    if hard:
        base = torch.tensor(bg + [0.0], dtype=fv.dtype, device=fv.device)
        base_aggr = fv.new_tensor([1e7, -1.0])
    else:
        base = torch.tensor(bg + [0.0], dtype=fv.dtype, device=fv.device)
        base_aggr = fv.new_tensor([math.exp(EPS / gamma_val), EPS])
    img = base.expand(B, TX * TX, P, 4)
    agg = base_aggr.expand(B, TX * TX, P, 2).clone()
    if outs:
        img = img.index_put((b, t), torch.cat(outs))
        agg[b, t] = torch.cat(aggrs)

    def untile(x):
        C = x.shape[-1]
        return (x.reshape(B, TX, TX, TILE, TILE, C).permute(0, 1, 3, 2, 4, 5)
                .reshape(B, S, S, C))

    p2f = None
    if p2f_sums is not None:
        p2f_sums = p2f_sums.reshape(B, F, 3)
        p2f = p2f_sums[..., :2] / p2f_sums[..., 2:].clamp_min(1e-12)
    return untile(img), untile(agg).permute(0, 3, 1, 2), p2f


@torch.no_grad()
def pair_counts(fv, image_size, sigma_val=1e-5, dist_eps=1e-10):
    """Of one render, the (pixel, face) pairs in the faces' widened bbox,
    those past the distance threshold, and of those the ones with depth in
    [near, far]: the counts the soft-rasterizer equations need work for,
    whatever the implementation."""
    S = int(image_size)
    threshold, margin = threshold_of(sigma_val, dist_eps)
    b, t, lists, counts = tile_lists(fv, S, margin)
    total = torch.zeros(3, dtype=torch.float64, device=fv.device)
    for lo, hi, K in _chunks(counts, TILE * TILE):
        fl = lists[lo:hi, :K]
        f = fl.clamp_min(0)
        fvc = fv[b[lo:hi, None], f]
        fi = face_info(fvc[..., 0], fvc[..., 1], fvc[..., 2])
        ok = (fl >= 0)[..., None] & fi["nondegen"]
        xp, yp, _, _ = tile_pixels(S, t[lo:hi], fv.dtype)
        pm = pair_math(fi, ok, xp, yp, threshold, margin, 1.0 / sigma_val)
        total += torch.stack([pm["in_box"].sum(), pm["valid"].sum(),
                              (pm["valid"] & pm["z_ok"]).sum()]).double()
    return [int(v) for v in total.tolist()]
