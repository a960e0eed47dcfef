"""The procedural "synthetic bird" category with ground truth, rendered
through the port's renderer (port of umr_tpu/data/synthetic_category.py):
the dataset behind experiments/synthetic_parity.py.

A smooth bird shape symmetric in y (the template's symmetry axis) with
small per-sample symmetric deformations, a procedural texture attached to
canonical sphere coordinates (up to a per-sample tint), four part maps
(head, neck, back, belly) rendered as one-hot textures in the SCOPS
channel layout, 15 farthest-point-sampled keypoints projected per view,
and side-ish cameras. The host helpers are copies of the JAX package's
and draw from numpy RandomStates in the same order, so a seed gives the
same meshes, cameras, tints and keypoints in both packages.

generate_dataset renders on the card (unless device="cpu"): per batch the
image on white and part maps A and B on black, each one launch of the
forward kernel on bins computed once. CategoryLoader yields the CUB batch
dict; with device_data=True its image-sized arrays are staged on the
device once (stage; loaders over one dataset can share one copy) and each
batch is an index_select there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import resolve_device
from ..image import prob2center, sample_prob
from ..native import edt_barrier
from ..ops.grid_sample import grid_sample
from ..parallel import shard_batch
from ..renderer import SoftRenderer

# part channels follow the SCOPS convention: 0 background, 1 head, 2 neck,
# 3 back, 4 belly
PART_NAMES = ("head", "neck", "back", "belly")
POINTS_NUM = {"head": 10, "neck": 10, "back": 30, "belly": 30}
PART_CH = {"head": 1, "neck": 2, "back": 3, "belly": 4}

# the ground-truth integrity bar: the share of projected vertices whose
# rendered mask samples > 0.5 (a rasterizer dropping fragments fails it)
MIN_VERTS_INSIDE = 0.95


def farthest_point_sample(pts, k, seed=0):
    """Deterministic FPS over [N,3] points -> k indices."""
    rng = np.random.RandomState(seed)
    n = pts.shape[0]
    sel = [int(rng.randint(n))]
    d = ((pts - pts[sel[0]]) ** 2).sum(1)
    for _ in range(k - 1):
        i = int(d.argmax())
        sel.append(i)
        d = np.minimum(d, ((pts - pts[i]) ** 2).sum(1))
    return np.asarray(sel, np.int64)


def base_bird(sphere_verts):
    """Canonical category shape: unit sphere -> elongated body with head
    and tail bumps, symmetric in y."""
    v = sphere_verts
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    out = v * np.array([0.62, 0.55, 1.0], np.float32)
    head = np.exp(-((z - 1.0) ** 2 + (x - 0.35) ** 2 + y ** 2) / 0.25)
    tail = np.exp(-((z + 1.0) ** 2 + x ** 2 + y ** 2) / 0.35)
    r = 1.0 + 0.35 * head + 0.15 * tail
    return (out * r[:, None]).astype(np.float32)


def sample_deform(sphere_verts, rng, n_bumps=3, amp=0.08):
    """Per-sample smooth symmetric radial deformation (multiplier [V,1])."""
    v = sphere_verts
    r = np.ones(v.shape[0], np.float32)
    for _ in range(n_bumps):
        c = rng.uniform(-1, 1, size=3).astype(np.float32)
        c /= max(np.linalg.norm(c), 1e-6)
        w = rng.uniform(0.15, 0.5)
        a = rng.uniform(-amp, amp)
        # symmetric: the bump at c and at its y-mirror
        for cc in (c, c * np.array([1, -1, 1], np.float32)):
            d2 = ((v - cc) ** 2).sum(1)
            r = r + a * np.exp(-d2 / w)
    return r[:, None]


def part_labels(sphere_verts):
    """[V] part id 0..3 (head, neck, back, belly) from canonical sphere
    coordinates; the parts partition the surface."""
    x, z = sphere_verts[:, 0], sphere_verts[:, 2]
    lab = np.full(sphere_verts.shape[0], 3, np.int64)   # belly
    lab[(z <= 0.55) & (x >= 0.0)] = 2                    # back (x is up)
    lab[(z > 0.55) & (z <= 0.8)] = 1                     # neck
    lab[z > 0.8] = 0                                     # head
    return lab


def face_part_labels(sphere_verts, faces):
    """[F] part id of each face's centroid."""
    cent = sphere_verts[faces].mean(axis=1)
    cent /= np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), 1e-6)
    return part_labels(cent)


def base_texture(sphere_verts, faces, tex_size):
    """[F, T2, 3] procedural per-face colours from canonical coordinates
    (|y| keeps them left/right symmetric)."""
    cent = sphere_verts[faces].mean(axis=1)
    x, y, z = cent[:, 0], np.abs(cent[:, 1]), cent[:, 2]
    r = 0.5 + 0.45 * np.sin(4.0 * z + 2.0 * x)
    g = 0.5 + 0.45 * np.sin(3.0 * x - 2.5 * z + 1.3)
    b = 0.5 + 0.45 * np.sin(5.0 * y + 1.1 * z + 2.6)
    col = np.stack([r, g, b], axis=1).clip(0.05, 0.95).astype(np.float32)
    T2 = tex_size * tex_size
    return np.repeat(col[:, None, :], T2, axis=1)


def _hamilton(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _axis_quat(axis, angle):
    u = np.zeros(3)
    u["xyz".index(axis)] = 1.0
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * u])


# the base orientation shows the bird side-on: its left flank (+y_obj)
# toward the eye at -z, the body axis z_obj along +x_cam and the up axis
# x_obj along -y_cam (up in the displayed image). q0 = Rz(-90) o Rx(-90)
_Q_SIDE = _hamilton(_axis_quat("z", -np.pi / 2), _axis_quat("x", -np.pi / 2))


def sample_camera(rng):
    """Ground-truth 7-vector [scale, tx, ty, quat]: side views orbiting
    the bird's up axis by 40-140 deg (90 is side-on), +-20 deg elevation
    about the camera's x axis."""
    az = np.deg2rad(rng.uniform(40.0, 140.0))
    el = np.deg2rad(rng.uniform(-20.0, 20.0))
    q_spin = _axis_quat("x", az - np.pi / 2)   # about the bird's up axis
    q_el = _axis_quat("x", el)                 # about the camera's x axis
    q = _hamilton(q_el, _hamilton(_Q_SIDE, q_spin))
    s = rng.uniform(0.62, 0.82)
    t = rng.uniform(-0.12, 0.12, size=2)
    return np.concatenate([[s], t, q]).astype(np.float32)


def generate_dataset(template, n, seed=0, image_size=256, batch=16,
                     kp_seed=17, deform_amp=0.08, device=None, stats=None):
    """Render n samples on `device` (the card unless "cpu"); returns a dict
    of stacked numpy arrays: img [n,S,S,3] in [0,1] on white, mask
    [n,S,S], part_prob [n,S,S,5], dts_barrier [n,S,S,1], kp [n,15,3]
    ([-1,1] image coordinates and a visible flag), cam [n,7] and kp_idx
    [15].

    deform_amp=0 disables the per-sample deformation (every sample is
    base_bird). Raises RuntimeError when fewer than MIN_VERTS_INSIDE of a
    batch's projected vertices land inside its rendered masks. `stats`, a
    dict, receives per batch "verts_inside" and "render_s" (the renders
    and the check, the card synchronised)."""
    device = resolve_device(device)
    S = image_size
    sphere = template.verts / np.maximum(
        np.linalg.norm(template.verts, axis=1, keepdims=True), 1e-6)
    faces_np = template.faces
    rng = np.random.RandomState(seed)

    base_v = base_bird(sphere)
    tex0 = base_texture(sphere, faces_np, template.tex_size)
    flab = face_part_labels(sphere, faces_np)
    T2 = template.tex_size ** 2
    # one-hot part textures: render A carries parts 1..3 (head, neck, back)
    # in rgb, render B part 4 (belly) in r
    texA = np.zeros((template.num_faces, T2, 3), np.float32)
    texB = np.zeros((template.num_faces, T2, 3), np.float32)
    for pid in range(4):
        sel = flab == pid
        if pid < 3:
            texA[sel, :, pid] = 1.0
        else:
            texB[sel, :, 0] = 1.0

    kp_idx = farthest_point_sample(base_v, 15, seed=kp_seed)

    img_renderer = SoftRenderer(
        image_size=S, render_type="softmax", anti_aliasing=True,
        ambient_intensity=1.0, directional_intensity=0.0,
        background_color=(1.0, 1.0, 1.0))
    part_renderer = dataclasses.replace(img_renderer,
                                        background_color=(0.0, 0.0, 0.0))
    faces = torch.as_tensor(faces_np, device=device)
    texA_t = torch.as_tensor(texA, device=device)[None]
    texB_t = torch.as_tensor(texB, device=device)[None]
    kp_idx_t = torch.as_tensor(kp_idx, device=device)
    if stats is not None:
        stats.setdefault("verts_inside", [])
        stats.setdefault("render_s", [])

    out = {k: [] for k in ("img", "mask", "part_prob", "kp", "cam")}
    for start in range(0, n, batch):
        bs = min(batch, n - start)
        verts = np.stack([
            base_v * sample_deform(sphere, rng, amp=deform_amp)
            for _ in range(bs)])
        cams = np.stack([sample_camera(rng) for _ in range(bs)])
        tint = rng.uniform(0.75, 1.1, size=(bs, 1, 1, 3)).astype(np.float32)
        tex = np.clip(tex0[None] * tint, 0.0, 1.0)
        t0 = time.perf_counter()
        with torch.no_grad():
            v = torch.as_tensor(verts, device=device)
            c = torch.as_tensor(cams, device=device)
            # the three renders share the geometry, so they share its bins
            bins = (img_renderer.compute_bins(v, faces, c)
                    if img_renderer.uses_kernel(device) else None)
            rgba = img_renderer.render(
                v, faces, c, torch.as_tensor(tex, device=device),
                bins=bins).rgba
            pA = part_renderer.render(
                v, faces, c, texA_t.expand(bs, -1, -1, -1),
                bins=bins).rgba[..., :3]
            pB = part_renderer.render(
                v, faces, c, texB_t.expand(bs, -1, -1, -1),
                bins=bins).rgba[..., :1]
            proj = img_renderer.project_points(v, c)
            mask = rgba[..., 3].clamp(0.0, 1.0)
            # every surface vertex projects inside the silhouette, so the
            # soft mask sampled there is ~1 away from edges: fragments
            # dropped by the rasterizer (an undersized per-tile cap) fail
            # this instead of poisoning the dataset
            m_at_v = grid_sample(mask[..., None], proj)[..., 0]
            inside = float((m_at_v > 0.5).float().mean())
            if stats is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                stats["verts_inside"].append(inside)
                stats["render_s"].append(time.perf_counter() - t0)
            if inside < MIN_VERTS_INSIDE:
                raise RuntimeError(
                    f"rendered masks have holes: only {inside:.1%} of "
                    "projected ground-truth vertices sample mask>0.5 "
                    f"(bar {MIN_VERTS_INSIDE:.0%}): rasterizer fragment "
                    "drop? (check the per-tile face caps and the binning)")
            img = rgba[..., :3].clamp(0.0, 1.0)
            parts = (torch.cat([pA, pB], dim=-1).clamp(0.0, 1.0)
                     * mask[..., None])
            bg = (1.0 - parts.sum(-1, keepdim=True)).clamp(0.0, 1.0)
            part_prob = torch.cat([bg, parts], dim=-1)
            kp2d = proj[:, kp_idx_t]
            kp = torch.cat([kp2d, torch.ones_like(kp2d[..., :1])], dim=-1)
        out["img"].append(img.cpu().numpy())
        out["mask"].append(mask.cpu().numpy())
        out["part_prob"].append(part_prob.cpu().numpy())
        out["kp"].append(kp.cpu().numpy())
        out["cam"].append(cams)
    data = {k: np.concatenate(v).astype(np.float32) for k, v in out.items()}
    data["dts_barrier"] = np.stack([
        edt_barrier(m) for m in (data["mask"] > 0.5).astype(np.float32)
    ])[..., None]
    data["kp_idx"] = kp_idx
    if device.type == "cuda":
        # the renders' buffers go back before training claims the card
        torch.cuda.empty_cache()
    return data


def stage(data, device=None, use_scops=True):
    """img, mask, dts_barrier and, with use_scops, part_prob of a generated
    dataset as float32 tensors on `device` (the card unless "cpu"): the
    arrays a device_data CategoryLoader indexes."""
    device = resolve_device(device)
    keys = ["img", "mask", "dts_barrier"] + (["part_prob"] if use_scops
                                             else [])
    return {k: torch.from_numpy(np.ascontiguousarray(
        data[k], np.float32)).to(device) for k in keys}


class CategoryLoader:
    """An in-memory loader over a generated dataset, yielding the CUB batch
    dict (img, mask, dts_barrier, kp and, with use_scops, part_prob and
    the {part}_points, re-sampled per visit on the host with the loader's
    RandomState, in the JAX package's order).

    device_data=True stages img, mask, dts_barrier (and part_prob) on
    `device` (the card unless "cpu") as float32 once, and yields those
    entries as index_selects there: a batch then copies only its index
    and its small host arrays (kp, the part points) to the device. At
    n=384 and 256^2 the staged set is ~1.0 GB. `staged`, stage(data)'s
    arrays, makes a device_data loader index that copy instead of staging
    its own. Every __iter__ advances the epoch that seeds the shuffle.

    batch_size is the global batch: in a group of ranks (parallel/
    mesh.py) rank r gets block r of each global batch, the part points
    drawn for the whole batch (one process's draws), and device_data
    stages on the rank's own card. PairLoader, which feeds evaluation,
    gives every process the whole order."""

    def __init__(self, data, batch_size, shuffle=True, seed=0,
                 use_scops=True, drop_last=True, device_data=False,
                 device=None, staged=None):
        self.data = data
        self.n = data["img"].shape[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.use_scops = use_scops
        self.drop_last = drop_last
        self.device_data = device_data or staged is not None
        self.device = (staged["img"].device if staged is not None
                       else resolve_device(device) if device_data else None)
        self._dev = staged
        self._epoch = 0

    def _device_arrays(self):
        if self._dev is None:
            self._dev = stage(self.data, self.device, self.use_scops)
        keys = ["img", "mask", "dts_barrier"] + (["part_prob"]
                                                 if self.use_scops else [])
        return {k: self._dev[k] for k in keys}

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def _points(self, part_prob, mask, rng):
        out = {}
        for name in PART_NAMES:
            ch = PART_CH[name]
            center = prob2center(part_prob, mask, ch=ch)
            out[f"{name}_points"] = sample_prob(
                part_prob, mask, center, POINTS_NUM[name], ch=ch, rng=rng)
        return out

    def __iter__(self):
        order = np.arange(self.n)
        rng = np.random.RandomState(self.seed + self._epoch)
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        dev = self._device_arrays() if self.device_data else None
        for bi in range(len(self)):
            batch_idx = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            idx = shard_batch({"idx": batch_idx})["idx"]
            if dev is not None:
                idxd = torch.as_tensor(idx, device=self.device)
                batch = {k: v.index_select(0, idxd) for k, v in dev.items()}
                batch["kp"] = self.data["kp"][idx]
            else:
                batch = {
                    "img": self.data["img"][idx],
                    "mask": self.data["mask"][idx],
                    "dts_barrier": self.data["dts_barrier"][idx],
                    "kp": self.data["kp"][idx],
                }
                if self.use_scops:
                    batch["part_prob"] = self.data["part_prob"][idx]
            if self.use_scops:
                pts = [self._points(self.data["part_prob"][i],
                                    self.data["mask"][i], rng)
                       for i in batch_idx]
                batch.update(shard_batch({
                    k: np.stack([p[k] for p in pts]).astype(np.float32)
                    for k in pts[0]}))
            yield batch


def make_pair_orders(n, n_pairs, seed=0):
    """Deterministic random pair indices with replacement, self-pairs
    resampled away (a same-image pair would score a free PCK hit)."""
    rng = np.random.RandomState(seed)
    o1 = rng.randint(0, n, size=n_pairs)
    o2 = rng.randint(0, n, size=n_pairs)
    while np.any(o1 == o2):
        eq = o1 == o2
        o2[eq] = rng.randint(0, n, size=int(eq.sum()))
    return o1, o2


class PairLoader:
    """Single-sample host batches (img, mask, kp) over a fixed index order
    of the test split: two of them, over the two halves of
    make_pair_orders, form test_kp's pairs."""

    def __init__(self, data, order):
        self.data = data
        self.order = np.asarray(order)

    def __len__(self):
        return len(self.order)

    def __iter__(self):
        for i in self.order:
            yield {
                "img": self.data["img"][i:i + 1],
                "mask": self.data["mask"][i:i + 1],
                "kp": self.data["kp"][i:i + 1],
            }
