"""CUB-200-2011 data path (port of umr_tpu/data/cub.py): the .mat
annotations and SfM poses, the bbox pad / jitter / square crop to
img_size, random mirroring (keypoints permuted, pose and part map
flipped), SCOPS part maps with their centres and sampled part points, and
the EDT barrier map (native.py) computed in the loader's threads.

Images are read by png.read_image: PNG on the host, JPEG (CUB's format)
through nvJPEG on `device`; the crop chain runs in float64 on the host
(image.py, the resize through torch on the CPU) and casts to float32 at
the end, as the JAX package's. Draws come from one RandomState per
dataset, shared by the loader's threads: with more than one worker their
order interleaves as in the JAX package. tests/test_torch_cub.py pins the
samples equal to the JAX package's.

  --cub_dir <dir>/images/<class>/<name>.jpg
  --cub_cache_dir <dir>/data/{split}_cub_cleaned.mat,
                  <dir>/sfm/anno_{split}.mat
  --scops_path <dir>/<class>/<name>_<index>.npy (in the 256 crop's frame)
"""

from __future__ import annotations

import os.path as osp
import threading
import time

import numpy as np

from .. import image as image_utils
from ..native import edt_barrier
from ..ops.quaternion import mirror_quat_np, quat_from_matrix_np
from ..parallel import data_rank_and_size
from ..png import read_image
from .loader import DataLoader

# CUB's 15-keypoint left/right permutation
KP_PERM = np.array([1, 2, 3, 4, 5, 6, 11, 12, 13, 10, 7, 8, 9, 14, 15]) - 1
# the parts a sample draws points of, with their SCOPS channels, in the
# order of the draws
PART_CHANNELS = (("head", 1), ("neck", 2), ("back", 3), ("belly", 4))


class CUBDataset:
    """Dict samples: img [S,S,3] and flip_img in [0,1], mask [S,S] and
    flip_mask, kp [15,3] in [-1,1] with the visibility, sfm_pose [7]
    (scale, trans, quaternion), inds, img_path, dts_barrier [S,S,1] and,
    with opts.use_scops, part_prob [S,S,5] with {head,neck,back,belly}
    _center and _points.

    timings, when set to a dict, accumulates the seconds the samples
    spend (summed over threads) in "read" (the file and its decode),
    "crop_resize" (the crop chain, the mirror and the flip copies),
    "parts" (the part map's load and points) and "edt"."""

    def __init__(self, opts, filter_key=None, mirror=True, head_points_num=10,
                 belly_points_num=30, neck_points_num=10, back_points_num=30,
                 compute_dt=True, seed=0, device=None):
        import scipy.io as sio

        self.opts = opts
        self.img_size = opts.img_size
        self.jitter_frac = opts.jitter_frac
        self.padding_frac = opts.padding_frac
        self.filter_key = filter_key
        self.mirror = mirror
        self.compute_dt = compute_dt
        self.device = device
        self.rng = np.random.RandomState(seed)
        self.points_num = dict(
            head=head_points_num, belly=belly_points_num,
            neck=neck_points_num, back=back_points_num,
        )
        self.timings = None
        self._tlock = threading.Lock()

        self.img_dir = osp.join(opts.cub_dir, "images")
        anno_path = osp.join(
            opts.cub_cache_dir, "data", f"{opts.split}_cub_cleaned.mat")
        anno_sfm_path = osp.join(
            opts.cub_cache_dir, "sfm", f"anno_{opts.split}.mat")
        if not osp.exists(anno_path):
            raise FileNotFoundError(
                f"{anno_path} does not exist: set --cub_cache_dir")
        self.anno = sio.loadmat(
            anno_path, struct_as_record=False, squeeze_me=True)["images"]
        self.anno_sfm = sio.loadmat(
            anno_sfm_path, struct_as_record=False, squeeze_me=True
        )["sfm_anno"]
        self.num_imgs = len(self.anno)
        self.kp_perm = KP_PERM

    def __len__(self):
        return self.num_imgs

    def _tick(self, key, t0):
        """Add the time since t0 to timings[key]; returns the time now."""
        now = time.perf_counter()
        if self.timings is not None:
            with self._tlock:
                self.timings[key] = self.timings.get(key, 0.0) + now - t0
        return now

    def _load_image(self, data):
        img_path = osp.join(self.img_dir, str(data.rel_path))
        img = read_image(img_path, self.device) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img[..., :3], img_path

    def forward_img(self, index):
        data = self.anno[index]
        data_sfm = self.anno_sfm[index]

        sfm_pose = [np.copy(data_sfm.scale), np.copy(data_sfm.trans),
                    np.copy(data_sfm.rot)]
        sfm_rot = np.pad(sfm_pose[2], (0, 1), "constant")
        sfm_rot[3, 3] = 1
        sfm_pose[2] = quat_from_matrix_np(sfm_rot)

        t = time.perf_counter()
        img, img_path = self._load_image(data)
        t = self._tick("read", t)
        mask = np.expand_dims(data.mask, 2)

        bbox = np.array(
            [data.bbox.x1, data.bbox.y1, data.bbox.x2, data.bbox.y2], float
        ) - 1

        parts = data.parts.T.astype(float)
        kp = np.copy(parts)
        vis = kp[:, 2] > 0
        kp[vis, :2] -= 1

        jf = self.jitter_frac if self.opts.split == "train" else 0.0
        bbox = image_utils.peturb_bbox(
            bbox, pf=self.padding_frac, jf=jf, rng=self.rng)
        bbox = image_utils.square_bbox(bbox)

        img = image_utils.crop(img, bbox, bgval=1)
        mask = image_utils.crop(mask, bbox, bgval=0)
        kp[vis, 0] -= bbox[0]
        kp[vis, 1] -= bbox[1]
        sfm_pose[1][0] -= bbox[0]
        sfm_pose[1][1] -= bbox[1]

        # scale to img_size, in float64
        bw, bh = img.shape[0], img.shape[1]
        scale = self.img_size / float(max(bw, bh))
        img, _ = image_utils.resize_img(img, scale)
        mask, _ = image_utils.resize_img(mask, scale)
        if mask.ndim == 2:
            mask = mask[..., None]
        kp[vis, :2] *= scale
        sfm_pose[0] *= scale
        sfm_pose[1] *= scale
        t = self._tick("crop_resize", t)

        part_prob = None
        if self.opts.use_scops:
            # the part maps are read as they are: in the 256 crop's frame
            tmp = img_path.split("/")
            img_nm = tmp[-1].split(".")[0] + "_" + str(index) + ".npy"
            part_prob = np.load(osp.join(self.opts.scops_path, tmp[-2],
                                         img_nm))
            t = self._tick("parts", t)

        if self.mirror and self.rng.rand() > 0.5:
            img, mask, kp, sfm_pose, part_prob = self.mirror_image(
                img, mask, kp, sfm_pose, part_prob)

        img_h, img_w = img.shape[:2]
        kp_norm, sfm_pose = self.normalize_kp(kp, sfm_pose, img_h, img_w)

        out = {
            "img": img.astype(np.float32),
            "kp": kp_norm.astype(np.float32),
            "mask": mask[..., 0].astype(np.float32),
            "sfm_pose": sfm_pose,
            "img_path": img_path,
        }
        t = self._tick("crop_resize", t)

        if self.opts.use_scops:
            mask2d = out["mask"]
            for name, ch in PART_CHANNELS:
                center = image_utils.prob2center(part_prob, mask2d, ch=ch)
                pts = image_utils.sample_prob(
                    part_prob, mask2d, center, self.points_num[name], ch=ch,
                    rng=self.rng)
                out[f"{name}_center"] = center
                out[f"{name}_points"] = pts.astype(np.float32)
            out["part_prob"] = part_prob.astype(np.float32)
            self._tick("parts", t)
        return out

    def normalize_kp(self, kp, sfm_pose, img_h, img_w):
        """Keypoints and the pose's translation to [-1, 1] image units;
        invisible keypoints zeroed."""
        vis = kp[:, 2, None] > 0
        new_kp = np.stack(
            [2 * (kp[:, 0] / img_w) - 1, 2 * (kp[:, 1] / img_h) - 1,
             kp[:, 2]]).T
        sfm_pose[0] *= (1.0 / img_w + 1.0 / img_h)
        sfm_pose[1][0] = 2.0 * (sfm_pose[1][0] / img_w) - 1
        sfm_pose[1][1] = 2.0 * (sfm_pose[1][1] / img_h) - 1
        return vis * new_kp, sfm_pose

    def mirror_image(self, img, mask, kp, sfm_pose, part_map=None):
        """The x-flip: image, mask and part map flipped, keypoints flipped
        and then permuted left to right, the pose mirrored."""
        img = img[:, ::-1, :].copy()
        mask = mask[:, ::-1].copy()
        new_x = img.shape[1] - kp[:, 0] - 1
        kp = np.hstack((new_x[:, None], kp[:, 1:]))[self.kp_perm, :]
        sfm_pose[2] = mirror_quat_np(sfm_pose[2])
        sfm_pose[1][0] = img.shape[1] - sfm_pose[1][0] - 1
        if part_map is not None:
            part_map = part_map[:, ::-1, :].copy()
        return img, mask, kp, sfm_pose, part_map

    def __getitem__(self, index):
        out = self.forward_img(index)
        t = time.perf_counter()
        sfm_pose = out.pop("sfm_pose")
        sfm_pose[0].shape = 1
        elem = dict(out)
        elem["sfm_pose"] = np.concatenate(
            [np.asarray(sfm_pose[0], np.float32).reshape(-1),
             np.asarray(sfm_pose[1], np.float32).reshape(-1),
             np.asarray(sfm_pose[2], np.float32).reshape(-1)])
        elem["inds"] = np.int64(index)
        elem["flip_img"] = elem["img"][:, ::-1, :].copy()
        elem["flip_mask"] = elem["mask"][:, ::-1].copy()
        t = self._tick("crop_resize", t)
        if self.compute_dt:
            elem["dts_barrier"] = edt_barrier(elem["mask"])[..., None]
            self._tick("edt", t)
        if self.filter_key is not None:
            if self.filter_key == "sfm_pose":
                return {"vis": out["kp"][:, 2], "sfm_pose": elem["sfm_pose"]}
            return {self.filter_key: elem[self.filter_key]}
        return elem


class CUBTestPairDataset:
    """Random test pairs, seeded by the dataset's size: filter_key 1
    yields each pair's first image, 2 its second."""

    def __init__(self, opts, filter_key, device=None):
        self.filter_key = filter_key
        self.sdset = CUBDataset(opts, mirror=False, device=device)
        rng = np.random.RandomState(len(self.sdset))
        all_indices = np.arange(len(self.sdset))
        count = opts.number_pairs
        self.tuples = list(zip(rng.choice(all_indices, count),
                               rng.choice(all_indices, count)))

    def __len__(self):
        return len(self.tuples)

    def __getitem__(self, index):
        i1, i2 = self.tuples[index]
        return self.sdset[i1 if self.filter_key == 1 else i2]


def data_loader(opts, shuffle=True, mirror=True, process_shard=None,
                device=None):
    """The CUB loader of opts.split. process_shard (default: shuffle)
    gives each rank of the group (parallel/mesh.py) its interleaved slice
    of every epoch, in batches of batch_size / ranks (opts.batch_size is
    the global batch); evaluation passes (shuffle=False) cover the whole
    split in every process. JPEG images decode on `device` (the card
    unless named)."""
    dset = CUBDataset(opts, mirror=mirror, device=device)
    if process_shard is None:
        process_shard = shuffle
    pi, pc = data_rank_and_size() if process_shard else (0, 1)
    return DataLoader(
        dset, opts.batch_size // pc, shuffle=shuffle,
        num_workers=opts.n_data_workers, drop_last=True, seed=opts.seed,
        process_index=pi, process_count=pc)


def cub_test_pair_dataloader(opts, filter_key, shuffle=False, device=None):
    dset = CUBTestPairDataset(opts, filter_key, device=device)
    return DataLoader(
        dset, 1, shuffle=shuffle, num_workers=opts.n_data_workers,
        drop_last=False)
