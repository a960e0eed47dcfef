"""Wrappers of the hand-written CUDA rasterizer kernels, forward
(csrc/raster_fwd.cu, replacing umr_tpu/ops/raster_kernel.py::_fwd_kernel
with its p2f side output) and backward (csrc/raster_bwd.cu, replacing umr_tpu/ops/
raster_kernel_bwd.py::_bwd_kernel), joined by a torch.autograd.Function
(the counterpart of umr_tpu/ops/raster_kernel.py::_pallas_raster_vjp).

On a CUDA tensor, soft_rasterize_fwd launches the forward kernel and its
backward the backward kernel, over the bins the caller gives or else over
full bins (ops/raster_bins.py::full_raster_bins: every face a tile
reaches). Full bins are made at each launch, forward and backward, and
not kept between them: their entry array is sized for the worst case,
and kept it would stand through the whole step. Neither falls back. On a
CPU tensor the Function runs the kernels' plain versions,
ops/rasterize.py::soft_rasterize and ops/rasterize_bwd.py::
soft_rasterize_bwd, so the CPU tests drive the card's gradient route.
Where p2f is asked for, the plain forward runs one face per chunk, so
that its p2f follows the kernel's rule (each pair weighted by the pixel's
running max after that face; see ops/rasterize.py).

The kernels, with the binning kernels of csrc/raster_bins.cu, are built
at first use with nvcc into umr_tpu_torch/build/, one compiler per
source, all started together, linked into one shared library with a
plain C interface loaded through ctypes, keyed by a hash of the sources
and flags. A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .raster_bins import TILE_SIZE, full_entries, full_raster_bins
from .rasterize import (EPS, FAR, NEAR, RasterOut, normalize_p2f,
                        soft_rasterize, threshold_of)
from .rasterize_bwd import soft_rasterize_bwd

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# --fmad=false: no FMA contraction, so the per-pair arithmetic rounds as the
# plain version's does (see csrc/raster_common.cuh)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-O3", "-std=c++17", "--fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v")

# the kernels' tile is TILE_SIZE (32x32 pixels, 256 threads of 4
# pixels); MAX_COVER is the JAX package's bound on the tiles a face's bbox
# spans per axis, for compute_raster_bins with its caps (the tools that
# compare with its layout)
MAX_COVER = 4

# kernel launches made by the forward and the backward wrapper, and the
# forward's launches that wrote p2f (also counted in LAUNCHES); callers
# reset and read them
LAUNCHES = 0
BWD_LAUNCHES = 0
P2F_LAUNCHES = 0

_lib = None
BUILD_LOG = ""   # nvcc's output (ptxas registers / spills) of the last build


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _run(cmds):
    """Run the commands concurrently; raise with the output of a failure.
    Returns their joint output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def build_library(csrc, build_dir):
    """Compile csrc/*.cu (once per hash of the sources and flags) into a
    shared library under build_dir and load it; returns (the library,
    nvcc's output, kept beside the library)."""
    csrc, build_dir = Path(csrc), Path(build_dir)
    sources = sorted(csrc.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(csrc.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = build_dir / f"libumr_kernels_{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    if not so.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            objs = [os.path.join(tmp, s.stem + ".o") for s in sources]
            nvcc = _nvcc()
            log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                        for s, o in zip(sources, objs)])
            out = os.path.join(tmp, so.name)
            log += _run([[nvcc, *ARCH, "-shared", "-o", out, *objs]])
            log_path.write_text(log)
            os.replace(out, so)
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.umr_raster_fwd.argtypes = (
        [vp] * 7 + [ci] * 6 + [cf] * 14 + [ci] * 3 + [vp])
    lib.umr_raster_fwd.restype = ci
    lib.umr_raster_bwd.argtypes = (
        [vp] * 9 + [ci] * 6 + [cf] * 10 + [ci] * 3 + [vp])
    lib.umr_raster_bwd.restype = ci
    if hasattr(lib, "umr_raster_bins"):     # trees before the bins kernel
        lib.umr_raster_bins.argtypes = (
            [vp] * 5 + [ci] * 4 + [cf] + [vp] * 2)
        lib.umr_raster_bins.restype = ci
    lib.umr_cuda_error_string.argtypes = [ci]
    lib.umr_cuda_error_string.restype = ctypes.c_char_p
    return lib, log


def build():
    """Compile the package's csrc/*.cu (once per source hash) and load the
    library the wrappers launch."""
    global _lib, BUILD_LOG
    if _lib is None:
        _lib, BUILD_LOG = build_library(CSRC, BUILD_DIR)
    return _lib


def pixel_rect(box, S, tile):
    """The backward kernel's pixel rectangle (csrc/raster_bwd.cu::
    pixel_rect), in plain torch: box [..., 4] float32 margin-expanded
    bboxes (maxx + m, minx - m, maxy + m, miny - m, as face_setup writes
    them) and the tile index -> int64 [..., 4] (col0, row0, width,
    height) in tile-local pixels; width or height <= 0 when empty. Used
    by the tests, to show the rectangle holds every pixel the bbox test
    passes."""
    b = box.double()
    TX = S // TILE_SIZE
    x0 = torch.as_tensor((tile % TX) * TILE_SIZE, dtype=torch.float64)
    y0 = torch.as_tensor((tile // TX) * TILE_SIZE, dtype=torch.float64)
    c_lo = torch.ceil((b[..., 1] * S + (S - 1.0)) * 0.5 - 1e-3)
    c_hi = torch.floor((b[..., 0] * S + (S - 1.0)) * 0.5 + 1e-3)
    r_lo = torch.ceil(((S - 1.0) - b[..., 2] * S) * 0.5 - 1e-3)
    r_hi = torch.floor(((S - 1.0) - b[..., 3] * S) * 0.5 + 1e-3)
    c0 = torch.minimum(torch.maximum(c_lo, x0), x0 + TILE_SIZE)
    c1 = torch.maximum(torch.minimum(c_hi, x0 + TILE_SIZE - 1), x0 - 1)
    r0 = torch.minimum(torch.maximum(r_lo, y0), y0 + TILE_SIZE)
    r1 = torch.maximum(torch.minimum(r_hi, y0 + TILE_SIZE - 1), y0 - 1)
    return torch.stack([c0 - x0, r0 - y0, c1 - c0 + 1, r1 - r0 + 1],
                       -1).long()


FWD_THREADS, FWD_SLOTS = 256, 4   # the forward's threads, pixels a thread


def fwd_slot_pixels():
    """The forward kernel's slot layout (csrc/raster_fwd.cu::slot_col,
    slot_row), in plain torch: int64 [FWD_SLOTS, FWD_THREADS, 2], the
    tile-local (row, col) of each thread's q-th pixel. Slot q of warp w
    is the 8x4 pixel block (w % 4, 2 q + w / 4), lane l its pixel
    (l % 8, l / 8). Used by the tests, to show the slots cover the tile
    once, in 8x4 blocks, and that fwd_slot_of inverts them."""
    tid = torch.arange(FWD_THREADS)
    q = torch.arange(FWD_SLOTS)[:, None]
    col = ((tid >> 5) & 3) * 8 + (tid & 7)
    row = (2 * q + (tid >> 7)) * 4 + ((tid >> 3) & 3)
    return torch.stack(torch.broadcast_tensors(row, col[None]), -1)


def fwd_slot_of(row, col):
    """The slot q * FWD_THREADS + tid holding tile-local pixel (row, col)
    (csrc/raster_fwd.cu::slot_of, which the write-out reads by), on int64
    tensors."""
    by, bx = row >> 2, col >> 3
    return ((by >> 1) * FWD_THREADS + ((by & 1) * 4 + bx) * 32
            + (row & 3) * 8 + (col & 7))


def fwd_block_hits(box, S, tile):
    """The forward kernel's block test (csrc/raster_fwd.cu, the slots'
    face masks), in plain torch: box [..., 4] float32 margin-expanded
    bboxes (maxx + m, minx - m, maxy + m, miny - m, as face_setup writes
    them) and the tile index (an int, or a tensor that broadcasts with
    box[..., 0]) -> bool [..., 8, 4], whether each bbox reaches each 8x4
    pixel block (block row, block column) of the tile: its x range meets
    the block's first and last columns' centres and its y range the
    rows', in the kernel's float32 compares. Used by the tests, to show a
    block the test leaves out holds no pixel the bbox test passes, and by
    experiments/raster_bound.py to count the blocks the walk visits."""
    TX = S // TILE_SIZE
    tile = torch.as_tensor(tile, device=box.device)[..., None]
    ar = torch.arange(TILE_SIZE, dtype=torch.float32, device=box.device)
    cx = (2.0 * ((tile % TX) * TILE_SIZE + ar) + 1.0 - S) / S   # [..., 32]
    cy = (2.0 * (S - 1 - ((tile // TX) * TILE_SIZE + ar)) + 1.0 - S) / S
    b = box[..., None, :]
    in_x = ((cx[..., 0::8] <= b[..., 0])
            & (cx[..., 7::8] >= b[..., 1]))                      # [..., 4]
    in_y = ((cy[..., 3::4] <= b[..., 2])
            & (cy[..., 0::4] >= b[..., 3]))                      # [..., 8]
    return in_y[..., :, None] & in_x[..., None, :]


def _check(t, name, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.umr_cuda_error_string(err).decode())


def _check_bins(bins, B, S, dev):
    """Bins of full_raster_bins, or of compute_raster_bins with any
    max_cover, mf_cap and entry_cap (the kernels read each tile's entry
    count from astarts), at image size S; returns the entries per
    image."""
    E_al = bins[0].shape[-1]
    _check(bins[0], "al_fids", (B, E_al), torch.int32, dev)
    _check(bins[1], "astarts", (B, (S // TILE_SIZE) ** 2 + 1), torch.int32,
           dev)
    return E_al


def _launch_fwd(fv, tex, bins, S, bg, sigma_val, dist_eps, gamma_val,
                mf_cap, hard, mask_only, need_p2f=False):
    """Forward kernel on CUDA tensors -> (rgba [B,S,S,4], aggr [B,2,S,S],
    p2f [B,F,2]). p2f is written by the softmax instance under need_p2f
    and is zeros otherwise (the hard body writes none)."""
    global LAUNCHES, P2F_LAUNCHES
    B, F = fv.shape[:2]
    T2 = tex.shape[2]
    dev = fv.device
    _check(fv, "face_vertices", (B, F, 3, 3), torch.float32, dev)
    _check(tex, "textures", (B, F, T2, 3), torch.float32, dev)
    E_al = _check_bins(bins, B, S, dev)
    threshold, margin = threshold_of(sigma_val, dist_eps)
    rgba = torch.empty((B, S, S, 4), dtype=torch.float32, device=dev)
    aggr = torch.empty((B, 2, S, S), dtype=torch.float32, device=dev)
    need_p2f = bool(need_p2f) and not hard
    # the kernel adds per-face sums of contrib * (gx, gy, 1) into this
    sums = torch.zeros((B, F, 3) if need_p2f else (0,), dtype=torch.float32,
                       device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.umr_raster_fwd(
            fv.data_ptr(), tex.data_ptr(), bins[0].data_ptr(),
            bins[1].data_ptr(), rgba.data_ptr(), aggr.data_ptr(),
            sums.data_ptr() if need_p2f else None,
            B, F, S, T2, E_al, int(mf_cap),
            NEAR, FAR, 1.0 / (FAR - NEAR), EPS, 1.0 / sigma_val,
            1.0 / gamma_val, threshold, margin,
            float(np.exp(EPS / gamma_val)), 1e-5, 1.0 - 1e-5, *bg,
            int(hard), int(bool(mask_only)), int(need_p2f), stream)
    _raise_on(lib, err, "raster_fwd")
    LAUNCHES += 1
    if not need_p2f:
        return rgba, aggr, fv.new_zeros((B, F, 2))
    P2F_LAUNCHES += 1
    return rgba, aggr, normalize_p2f(sums)


def raster_bwd(fv, tex, bins, rgba, aggr, g_rgba, S, sigma_val, dist_eps,
               gamma_val, mf_cap, mask_only=False, rgb_geom_detach=False,
               tex_grads=True):
    """Gradients of a softmax render: (grad_fv [B,F,3,3], grad_tex
    [B,F,T2,3]). On CUDA tensors the backward kernel over the forward's
    bins; on CPU tensors its plain version (which needs no bins)."""
    global BWD_LAUNCHES
    if not fv.is_cuda:
        return soft_rasterize_bwd(
            fv, tex, rgba, aggr, g_rgba, image_size=S, sigma_val=sigma_val,
            dist_eps=dist_eps, gamma_val=gamma_val, mask_only=mask_only,
            rgb_geom_detach=rgb_geom_detach, tex_grads=tex_grads)
    B, F = fv.shape[:2]
    T2 = tex.shape[2]
    dev = fv.device
    _check(fv, "face_vertices", (B, F, 3, 3), torch.float32, dev)
    _check(tex, "textures", (B, F, T2, 3), torch.float32, dev)
    E_al = _check_bins(bins, B, S, dev)
    g_rgba = g_rgba.contiguous()
    for t, name, shape in ((rgba, "rgba", (B, S, S, 4)),
                           (aggr, "aggr", (B, 2, S, S)),
                           (g_rgba, "g_rgba", (B, S, S, 4))):
        _check(t, name, shape, torch.float32, dev)
    threshold, margin = threshold_of(sigma_val, dist_eps)
    grad_fv = torch.zeros_like(fv)
    grad_tex = torch.zeros_like(tex)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.umr_raster_bwd(
            fv.data_ptr(), tex.data_ptr(), bins[0].data_ptr(),
            bins[1].data_ptr(), rgba.data_ptr(), aggr.data_ptr(),
            g_rgba.data_ptr(), grad_fv.data_ptr(), grad_tex.data_ptr(),
            B, F, S, T2, E_al, int(mf_cap),
            NEAR, FAR, 1.0 / (FAR - NEAR), 1.0 / sigma_val,
            1.0 / gamma_val, threshold, margin, 1e-5, 1.0 - 1e-5,
            1.0 / gamma_val / (NEAR - FAR),
            int(bool(mask_only)), int(bool(rgb_geom_detach)),
            int(bool(tex_grads)), stream)
    _raise_on(lib, err, "raster_bwd")
    BWD_LAUNCHES += 1
    return grad_fv, grad_tex


def _bins_of(fv, al_fids, astarts, kw):
    """The bins a launch walks: the caller's, or else (CUDA tensors) the
    full bins made now; the plain versions (CPU) take none."""
    if al_fids is not None:
        return al_fids, astarts
    if not fv.is_cuda:
        return None, None
    return full_raster_bins(fv, kw["S"], kw["sigma_val"], kw["dist_eps"])


class _Raster(torch.autograd.Function):
    """Forward kernel + backward kernel (plain versions on the CPU).
    Gradients go to the faces and texels; the bins get none, and aggr and
    p2f are outputs without gradients. The backward reuses the forward's
    rgba (at render size) and aggr, and the caller's bins or else full
    bins made again from the same faces (the same entries)."""

    @staticmethod
    def forward(ctx, fv, tex, al_fids, astarts, kw):
        if fv.is_cuda:
            rgba, aggr, p2f = _launch_fwd(
                fv, tex, _bins_of(fv, al_fids, astarts, kw), kw["S"],
                kw["bg"], kw["sigma_val"], kw["dist_eps"], kw["gamma_val"],
                kw["mf_cap"], kw["hard"], kw["mask_only"], kw["need_p2f"])
        else:
            # one face per chunk where p2f is read: the kernel's rule
            out = soft_rasterize(
                fv, tex, image_size=kw["S"], background_color=kw["bg"],
                sigma_val=kw["sigma_val"], dist_eps=kw["dist_eps"],
                gamma_val=kw["gamma_val"],
                aggr_func_rgb="hard" if kw["hard"] else "softmax",
                mask_only=kw["mask_only"], need_p2f=kw["need_p2f"],
                **({"face_chunk": 1} if kw["need_p2f"] else {}))
            rgba, aggr, p2f = out.rgba, out.aggr, out.p2f
        ctx.kw = kw
        ctx.save_for_backward(fv, tex, al_fids, astarts, rgba, aggr)
        ctx.mark_non_differentiable(aggr, p2f)
        return rgba, aggr, p2f

    @staticmethod
    def backward(ctx, g_rgba, _g_aggr, _g_p2f):
        fv, tex, al_fids, astarts, rgba, aggr = ctx.saved_tensors
        kw = ctx.kw
        if kw["hard"]:
            # hard RGB is a forward-only visibility pass: no backward
            return torch.zeros_like(fv), torch.zeros_like(tex), None, None, None
        gfv, gtex = raster_bwd(
            fv, tex, _bins_of(fv, al_fids, astarts, kw), rgba, aggr, g_rgba,
            kw["S"], kw["sigma_val"], kw["dist_eps"], kw["gamma_val"],
            kw["mf_cap"], kw["mask_only"], kw["rgb_geom_detach"],
            kw["tex_grads"])
        return gfv, gtex, None, None, None


def soft_rasterize_fwd(
    face_vertices,
    textures=None,
    image_size=256,
    background_color=(0.0, 0.0, 0.0),
    sigma_val=1e-5,
    dist_eps=1e-10,
    gamma_val=1e-4,
    aggr_func_rgb="softmax",
    mf_cap=None,
    need_p2f=False,
    mask_only=False,
    rgb_geom_detach=False,
    tex_grads=True,
    bins=None,
):
    """Rasterizer on the kernels' route, training-config subset (euclidean
    distance, product alpha, surface textures; softmax or hard RGB).

    face_vertices [B, F, 3, 3] float32; textures [B, F, T2, 3] or None.
    Same contract as ops/rasterize.py::soft_rasterize; image_size is a
    multiple of 32. Differentiable with the reference CUDA backward's
    semantics (ops/rasterize_bwd.py): rgb_geom_detach sends rgb gradients
    to the texels only, tex_grads=False gives the texels none (for
    textures the caller does not differentiate), hard mode has no
    backward. bins: (al_fids, astarts) at this image_size, of
    full_raster_bins or of compute_raster_bins with the JAX package's
    caps (a tool that holds the kernels to its layout); when None, the
    full bins, made at the forward's launch and again at the backward's,
    so that every face a tile reaches is rendered. mf_cap bounds the
    entries the kernels walk per tile (None: every entry; the JAX
    package's soft_rasterize_pallas pairs it with its bins' cap). Returns
    RasterOut; p2f is the per-face expected image coordinate under
    need_p2f (softmax; it carries no gradient), else zeros.
    """
    if aggr_func_rgb not in ("softmax", "hard"):
        raise ValueError(f"aggr_func_rgb={aggr_func_rgb!r}")
    B, F = face_vertices.shape[:2]
    S = int(image_size)
    if S % TILE_SIZE:
        raise ValueError(f"image_size={S} is not a multiple of the kernel's "
                         f"{TILE_SIZE}-pixel tile")
    if textures is None:
        textures = face_vertices.new_ones((B, F, 1, 3))
    al_fids, astarts = (None, None) if bins is None else bins
    if mf_cap is None:
        # a tile of any bins holds at most every face, padded to GROUP
        mf_cap = full_entries(F, 1)
    hard = aggr_func_rgb == "hard"
    kw = dict(S=S, bg=tuple(background_color)[:3]
              + (0.0,) * (3 - len(background_color)),
              sigma_val=sigma_val, dist_eps=dist_eps, gamma_val=gamma_val,
              mf_cap=int(mf_cap), hard=hard, mask_only=mask_only and not hard,
              rgb_geom_detach=rgb_geom_detach, tex_grads=tex_grads,
              need_p2f=bool(need_p2f) and not hard)
    rgba, aggr, p2f = _Raster.apply(face_vertices, textures, al_fids, astarts,
                                    kw)
    return RasterOut(rgba=rgba, p2f=p2f, aggr=aggr)
