"""The benchmark's inputs, made on the host from the run's seed: batches in
the CUB loader's layout and stage 2's semantic template.

batch() is a frozen copy of the program's data/synthetic.py::
synthetic_batch (ellipse masks, coloured noise inside them, four part
bumps and the part points sampled from them), with the distance-transform
barrier from scipy's EDT, as NVlabs UMR's utils/image.py computes it.
Every batch of a pool has the same sizes; batch i of a seed is drawn
from its own stream (seed, 1, i), so a pool is the same
whatever order or thread makes it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.ndimage import distance_transform_edt

PARTS = ("head", "belly", "neck", "back")
# the s2 part vertex sets (head, belly, neck, back): slices of a seeded
# permutation of the template's vertices
PART_SLICES = ((0, 100), (100, 250), (250, 330), (330, 480))


def rng_for(seed, *stream):
    """A numpy RandomState of its own for (seed, *stream); any seed >= 0."""
    ss = np.random.SeedSequence([int(seed), *stream])
    return np.random.RandomState(np.random.MT19937(ss))


def dt_barrier(mask, k=50.0):
    """sigmoid(k * (EDT outside - EDT inside) / max(H, W))."""
    dist_out = distance_transform_edt(1 - mask)
    dist_in = distance_transform_edt(mask)
    diff = (dist_out - dist_in) / max(mask.shape)
    return (1.0 / (1.0 + np.exp(-k * diff))).astype(np.float32)


def batch(rng, batch_size, image_size, num_parts=4, points=(10, 30, 10, 30)):
    """One loader batch: img [B,S,S,3] in [0, 1], mask [B,S,S], part_prob
    [B,S,S,P+1], {head,belly,neck,back}_points [B,n,2] in [-1, 1] and
    dts_barrier [B,S,S,1], float32."""
    B, S = batch_size, image_size
    imgs = np.zeros((B, S, S, 3), np.float32)
    masks = np.zeros((B, S, S), np.float32)
    part_prob = np.zeros((B, S, S, num_parts + 1), np.float32)
    pts = {k: [] for k in PARTS}
    y, x = np.mgrid[0:S, 0:S]
    for b in range(B):
        cx, cy = rng.uniform(0.35 * S, 0.65 * S, 2)
        rx, ry = rng.uniform(0.18 * S, 0.35 * S, 2)
        m = (((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 <= 1.0).astype(
            np.float32)
        masks[b] = m
        imgs[b] = rng.rand(S, S, 3) * m[..., None] + (1 - m[..., None])
        for ch, (ox, oy) in enumerate([(-0.4, 0), (0.4, 0), (0, -0.4),
                                       (0, 0.4)], start=1):
            px, py = cx + ox * rx, cy + oy * ry
            bump = np.exp(-(((x - px) ** 2 + (y - py) ** 2)
                            / (0.1 * S ** 2 / 16)))
            part_prob[b, :, :, ch] = bump * m
        part_prob[b, :, :, 0] = np.clip(
            1.0 - part_prob[b, :, :, 1:].sum(-1), 0, 1)
        for name, n, ch in zip(PARTS, points, (1, 4, 2, 3)):
            flat = (part_prob[b, :, :, min(ch, num_parts)] * m).reshape(-1)
            if flat.sum() < 1e-8:
                flat = m.reshape(-1)
            idx = rng.choice(S * S, size=n, p=flat / flat.sum())
            coords = np.stack([idx % S, idx // S], axis=1).astype(np.float32)
            pts[name].append(coords / S * 2 - 1)
    out = {"img": imgs, "mask": masks, "part_prob": part_prob,
           "dts_barrier": np.stack([dt_barrier(m) for m in masks])[..., None]}
    for name in PARTS:
        out[f"{name}_points"] = np.stack(pts[name]).astype(np.float32)
    return out


def pool(seed, n, batch_size, image_size, threads=4):
    """n batches of the seed, batch i from stream (seed, 1, i)."""
    with ThreadPoolExecutor(threads) as ex:
        futs = [ex.submit(batch, rng_for(seed, 1, i), batch_size,
                          image_size) for i in range(n)]
        return [f.result() for f in futs]


def semantic_template(seed, num_verts, num_parts=4, uv_shape=(128, 256)):
    """(UV label map [H, W] of labels 0..num_parts, the part vertex index
    arrays head, belly, neck, back) from stream (seed, 2)."""
    rng = rng_for(seed, 2)
    seg = rng.randint(0, num_parts + 1, size=uv_shape).astype(np.float32)
    perm = rng.permutation(num_verts)
    return seg, [perm[a:b].astype(np.int64) for a, b in PART_SLICES]
