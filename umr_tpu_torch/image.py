"""Host image utilities (copies of umr_tpu/utils/image.py): the CUB
crop chain (resize_img, peturb_bbox, square_bbox, crop), label-image
colouring, part-point sampling and the drawing helpers of the visuals
(KP_COLOR_TABLE, draw_kp_circles); the utilities no path calls: the
scipy distance transforms compute_dt and compute_dt_barrier (the data
paths' barrier is native.edt_barrier, which has no fallback to them) and
the Middlebury flow colouring flow_to_rgb.
tests/test_torch_host.py, tests/test_torch_cub.py and
tests/test_torch_synthetic_category.py pin them equal.

resize_img is the one that differs in its means: the JAX package calls
cv2.resize (bilinear, half-pixel centres), which the machine with the
card lacks; here F.interpolate(mode="bilinear", align_corners=False) on
the CPU computes the same values in the image's own dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_img(img, scale_factor):
    """img [H,W] or [H,W,C] resized bilinearly by scale_factor, the new size
    rounded -> (image, [actual factor along y, along x]). As cv2.resize,
    a size-1 channel is dropped: [H,W,1] gives [h,w]."""
    new_size = np.round(np.array(img.shape[:2]) * scale_factor).astype(int)
    x = torch.from_numpy(np.ascontiguousarray(img))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(int(new_size[0]), int(new_size[1])),
                      mode="bilinear", align_corners=False)[0]
    new_img = y[0] if y.shape[0] == 1 else y.permute(1, 2, 0)
    actual_factor = [new_size[0] / float(img.shape[0]),
                     new_size[1] / float(img.shape[1])]
    return new_img.numpy(), actual_factor


def peturb_bbox(bbox, pf=0, jf=0, rng=None):
    """Pad the bbox (x0, y0, x1, y1) by pf of its size and jitter each side
    by up to jf of it (four draws from rng, in the reference's order)."""
    rng = rng or np.random
    pet = [float(c) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    pet[0] -= pf * bw + (1 - 2 * rng.random()) * jf * bw
    pet[1] -= pf * bh + (1 - 2 * rng.random()) * jf * bh
    pet[2] += pf * bw + (1 - 2 * rng.random()) * jf * bw
    pet[3] += pf * bh + (1 - 2 * rng.random()) * jf * bh
    return pet


def square_bbox(bbox):
    """The integer square bbox around bbox's centre, of its longer side."""
    sq = [int(round(c)) for c in bbox]
    bw = sq[2] - sq[0] + 1
    bh = sq[3] - sq[1] + 1
    maxdim = float(max(bw, bh))
    dw2 = int(round((maxdim - bw) / 2.0))
    dh2 = int(round((maxdim - bh) / 2.0))
    sq[0] -= dw2
    sq[1] -= dh2
    sq[2] = int(sq[0] + maxdim - 1)
    sq[3] = int(sq[1] + maxdim - 1)
    return sq


def crop(img, bbox, bgval=0):
    """The [y0..y1, x0..x1] window of the bbox (rounded) -> float64
    [h,w,C] (C=1 for a 2-D image), the part outside the image bgval."""
    bbox = [int(round(c)) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    shape = np.shape(img)
    im_h, im_w = shape[0], shape[1]
    nc = 1 if len(shape) < 3 else shape[2]
    out = np.ones((bh, bw, nc)) * bgval
    x0s, x1s = max(0, bbox[0]), min(im_w, bbox[2] + 1)
    y0s, y1s = max(0, bbox[1]), min(im_h, bbox[3] + 1)
    x0t = x0s - bbox[0]
    y0t = y0s - bbox[1]
    img3 = img if img.ndim == 3 else img[..., None]
    out[y0t:y0t + (y1s - y0s), x0t:x0t + (x1s - x0s), :] = (
        img3[y0s:y1s, x0s:x1s, :])
    return out


def color_map(N=256, normalized=False):
    """PASCAL-style colour map [N, 3]: uint8, or float in [0, 1]."""

    def bitget(v, idx):
        return (v & (1 << idx)) != 0

    dtype = "float32" if normalized else "uint8"
    cmap = np.zeros((N, 3), dtype=dtype)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap / 255 if normalized else cmap


def colorize(gray, n=5):
    """Label image [H,W] -> colour image [H,W,3] uint8 (label 255 white)."""
    cmap = color_map(n)
    out = np.zeros(gray.shape + (3,), np.uint8)
    for label in range(n):
        out[gray == label] = cmap[label]
    out[gray == 255] = 255
    return out


def prob2center(part_prob, mask, ch=1):
    """Soft centroid (x, y) in [-1, 1] of channel `ch` of a part
    probability map [H,W,C] inside `mask` [H,W]."""
    p = part_prob[:, :, ch] * mask
    p = p / max(float(p.sum()), 1e-12)
    H, W = p.shape
    x_map = np.tile(np.arange(W), (H, 1)) / W * 2 - 1.0
    y_map = np.tile(np.arange(H), (W, 1)).T / H * 2 - 1.0
    return np.array([(p * x_map).sum(), (p * y_map).sum()], np.float32)


def sample_prob(part_prob, mask, center, num_samples=10, ch=1, rng=None):
    """num_samples points [n,2] of channel `ch`: 1.5x as many pixels drawn
    from the masked map (the mask alone where the channel is empty), the
    num_samples closest to `center` kept. As the reference, the pixel
    index is split by `% H` and `// W` and coordinates are divided by
    256 whatever the image size."""
    rng = rng or np.random
    init = int(num_samples * 1.5)
    p = part_prob[:, :, ch] * mask
    flat = p.reshape(-1).astype(np.float64)
    s = flat.sum()
    if s <= 0:
        flat = mask.reshape(-1).astype(np.float64)
        s = max(flat.sum(), 1.0)
    flat = flat / s
    H, W = p.shape
    samples = rng.choice(H * W, size=init, p=flat)
    coords = np.zeros((init, 2), np.float32)
    coords[:, 0] = samples % H
    coords[:, 1] = samples // W
    coords = (coords / 256.0) * 2 - 1
    dist = ((coords - center) ** 2).sum(1)
    top = np.argsort(dist)[:num_samples]
    return coords[top]


# 16-entry keypoint colour table (RGB)
KP_COLOR_TABLE = np.array([
    [0, 255, 0], [0, 0, 255], [0, 255, 255], [255, 0, 0],
    [255, 0, 255], [255, 255, 0], [0, 0, 255], [0, 128, 255],
    [128, 0, 255], [0, 128, 0], [128, 0, 0], [0, 0, 128],
    [128, 128, 0], [0, 128, 128], [128, 0, 128], [128, 128, 128],
], np.uint8)


def draw_kp_circles(img, kps_px, visible=None, radius=5, colors=None):
    """Filled keypoint discs on a copy of img [H,W,3] uint8; kps_px [K,2]
    pixel (x, y), truncated to integers; keypoints not visible or outside
    the image are skipped."""
    out = np.array(img, np.uint8, copy=True)
    H, W = out.shape[:2]
    colors = KP_COLOR_TABLE if colors is None else colors
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (xx ** 2 + yy ** 2) <= radius ** 2
    for i, (x, y) in enumerate(np.asarray(kps_px)[:, :2]):
        if visible is not None and not visible[i]:
            continue
        cx, cy = int(x), int(y)
        if not (0 <= cx < W and 0 <= cy < H):
            continue
        y0, y1 = max(cy - radius, 0), min(cy + radius + 1, H)
        x0, x1 = max(cx - radius, 0), min(cx + radius + 1, W)
        d = disk[y0 - (cy - radius):y1 - (cy - radius),
                 x0 - (cx - radius):x1 - (cx - radius)]
        out[y0:y1, x0:x1][d] = colors[i % len(colors)]
    return out


def compute_dt(mask):
    """Normalized EDT of the background (ref: utils/image.py:122-128)."""
    from scipy.ndimage import distance_transform_edt

    return distance_transform_edt(1 - mask) / max(mask.shape)


def compute_dt_barrier(mask, k=50):
    """Sigmoid-of-signed-EDT barrier map (ref: utils/image.py:130-141)."""
    from scipy.ndimage import distance_transform_edt

    dist_out = distance_transform_edt(1 - mask)
    dist_in = distance_transform_edt(mask)
    dist_diff = (dist_out - dist_in) / max(mask.shape)
    return 1.0 / (1.0 + np.exp(k * -dist_diff))


def _middlebury_wheel():
    """55-entry Middlebury flow color wheel (segment sizes RY=15, YG=6,
    GC=4, CB=11, BM=13, MR=6 — the standard code the reference vendors,
    ref: utils/image.py:378-425)."""
    segs = [(15, 0, 1), (6, 1, 0), (4, 1, 2), (11, 2, 1), (13, 2, 0),
            (6, 0, 2)]
    rows = []
    for i, (n, hold, ramp) in enumerate(segs):
        w = np.zeros((n, 3))
        w[:, hold] = 255
        r = np.floor(255 * np.arange(n) / n)
        # even segments ramp the moving channel up, odd segments down
        w[:, ramp] = r if i % 2 == 0 else 255 - r
        rows.append(w)
    return np.concatenate(rows)


def flow_to_rgb(flow, max_rad=None):
    """Flow [H,W,2] -> (rgb float32 [H,W,3] in [0,1], max radius), in
    Middlebury color code (vectorized port of the reference's
    flow_to_rgb/compute_color, ref: utils/image.py:290-376)."""
    u = np.array(flow[:, :, 0], float, copy=True)
    v = np.array(flow[:, :, 1], float, copy=True)
    unknown = (np.abs(u) > 1e7) | (np.abs(v) > 1e7) | np.isnan(u) \
        | np.isnan(v)
    u[unknown] = 0
    v[unknown] = 0

    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(-1.0, rad.max()) if max_rad is None else max_rad
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    rad = np.sqrt(u ** 2 + v ** 2)

    wheel = _middlebury_wheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi               # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = np.where(k0 + 1 == ncols + 1, 1, k0 + 1)
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0 - 1] / 255 + f * wheel[k1 - 1] / 255

    inside = (rad <= 1)[..., None]
    col = np.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    img = np.floor(255 * col)
    img[unknown] = 0
    return (img / 255.0).astype(np.float32), float(maxrad)
