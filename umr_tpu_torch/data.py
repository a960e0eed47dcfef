"""Synthetic batches with the structure of the CUB pipeline's output, for
tests and smoke runs without the dataset on disk (copy of
umr_tpu/data/synthetic.py::synthetic_batch; its distance-transform
barrier is umr_tpu/utils/image.py::compute_dt_barrier, with scipy, where
the JAX package calls its native C++ copy; tests/test_torch_host.py pins
both equal to the JAX package's).

Masks are ellipse blobs, images coloured noise inside the mask, part
probability maps four gaussian bumps inside the mask.
"""

from __future__ import annotations

import numpy as np


def _ellipse_mask(H, W, cx, cy, rx, ry):
    y, x = np.mgrid[0:H, 0:W]
    return (((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 <= 1.0).astype(
        np.float32)


def compute_dt_barrier(mask, k=50):
    """Sigmoid of the signed, normalised Euclidean distance transform of a
    [H, W] mask: ~0 inside, 0.5 on the boundary, -> 1 outside."""
    from scipy.ndimage import distance_transform_edt

    dist_out = distance_transform_edt(1 - mask)
    dist_in = distance_transform_edt(mask)
    dist_diff = (dist_out - dist_in) / max(mask.shape)
    return 1.0 / (1.0 + np.exp(k * -dist_diff))


def synthetic_batch(rng: np.random.RandomState, batch_size=4, image_size=64,
                    num_parts=4, points=(10, 30, 10, 30), with_dt=True):
    """A dict of channel-last numpy arrays: img, input_img, mask, kp,
    sfm_pose, part_prob, {head,belly,neck,back}_points, real_imgs and,
    with_dt, dts_barrier [B, H, W, 1]."""
    B, S = batch_size, image_size
    imgs = np.zeros((B, S, S, 3), np.float32)
    masks = np.zeros((B, S, S), np.float32)
    part_prob = np.zeros((B, S, S, num_parts + 1), np.float32)
    pts = {k: [] for k in ("head", "belly", "neck", "back")}

    for b in range(B):
        cx, cy = rng.uniform(0.35 * S, 0.65 * S, 2)
        rx, ry = rng.uniform(0.18 * S, 0.35 * S, 2)
        m = _ellipse_mask(S, S, cx, cy, rx, ry)
        masks[b] = m
        imgs[b] = rng.rand(S, S, 3) * m[..., None] + (1 - m[..., None])

        y, x = np.mgrid[0:S, 0:S]
        offsets = [(-0.4, 0), (0.4, 0), (0, -0.4), (0, 0.4)]
        for ch, (ox, oy) in enumerate(offsets, start=1):
            px, py = cx + ox * rx, cy + oy * ry
            bump = np.exp(-(((x - px) ** 2 + (y - py) ** 2)
                            / (0.1 * S ** 2 / 16)))
            part_prob[b, :, :, ch] = bump * m
        part_prob[b, :, :, 0] = np.clip(
            1.0 - part_prob[b, :, :, 1:].sum(-1), 0, 1)

        for name, n, ch in zip(("head", "belly", "neck", "back"), points,
                               (1, 4, 2, 3)):
            flat = (part_prob[b, :, :, min(ch, num_parts)] * m).reshape(-1)
            if flat.sum() < 1e-8:
                flat = m.reshape(-1)
            idx = rng.choice(S * S, size=n, p=flat / flat.sum())
            coords = np.stack([idx % S, idx // S], axis=1).astype(np.float32)
            pts[name].append(coords / S * 2 - 1)

    kps = np.zeros((B, 15, 3), np.float32)
    for b in range(B):
        ys, xs = np.nonzero(masks[b])
        sel = rng.randint(0, len(xs), size=15)
        kps[b, :, 0] = xs[sel] / S * 2 - 1
        kps[b, :, 1] = ys[sel] / S * 2 - 1
        kps[b, :, 2] = 1.0

    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    batch = {
        "img": imgs,
        "input_img": (imgs - mean) / std,
        "mask": masks,
        "kp": kps,
        "sfm_pose": np.tile(np.array([1, 0, 0, 1, 0, 0, 0], np.float32),
                            (B, 1)),
        "part_prob": part_prob,
        "real_imgs": imgs * masks[..., None],
    }
    for name in ("head", "belly", "neck", "back"):
        batch[f"{name}_points"] = np.stack(pts[name]).astype(np.float32)
    if with_dt:
        batch["dts_barrier"] = np.stack(
            [compute_dt_barrier(m) for m in masks]).astype(np.float32)[
                ..., None]
    return batch
