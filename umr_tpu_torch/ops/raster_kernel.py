"""Wrappers of the hand-written CUDA rasterizer kernels, forward
(csrc/raster_fwd.cu, replacing umr_tpu/ops/raster_kernel.py::_fwd_kernel
with its p2f side output) and backward (csrc/raster_bwd.cu, replacing umr_tpu/ops/
raster_kernel_bwd.py::_bwd_kernel), joined by a torch.autograd.Function
(the counterpart of umr_tpu/ops/raster_kernel.py::_pallas_raster_vjp).

On a CUDA tensor, soft_rasterize_fwd bins the faces (ops/raster_bins.py)
unless given bins, launches the forward kernel, and its backward launches
the backward kernel over the same bins; neither falls back. On a CPU
tensor the Function runs the kernels' plain versions,
ops/rasterize.py::soft_rasterize and ops/rasterize_bwd.py::
soft_rasterize_bwd, so the CPU tests drive the card's gradient route.
Where p2f is asked for, the plain forward runs one face per chunk, so
that its p2f follows the kernel's rule (each pair weighted by the pixel's
running max after that face; see ops/rasterize.py).

The kernels are built at first use with nvcc into umr_tpu_torch/build/,
one compiler per source, all started together, linked into one shared
library with a plain C interface loaded through ctypes, keyed by a hash of
the sources and flags. A missing nvcc or a failed build raises.
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

from .raster_bins import compute_raster_bins
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

# the kernels' tile (32x32 pixels, 256 threads of 4 pixels), and the
# bins' bound on the tiles a face's bbox spans per axis
TILE_SIZE = 32
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


def build():
    """Compile csrc/*.cu (once per source hash) and load the library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libumr_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, s.stem + ".o") for s in sources]
            nvcc = _nvcc()
            BUILD_LOG = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                              for s, o in zip(sources, objs)])
            out = os.path.join(tmp, so.name)
            BUILD_LOG += _run([[nvcc, *ARCH, "-shared", "-o", out, *objs]])
            os.replace(out, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.umr_raster_fwd.argtypes = (
        [vp] * 7 + [ci] * 6 + [cf] * 14 + [ci] * 3 + [vp])
    lib.umr_raster_fwd.restype = ci
    lib.umr_raster_bwd.argtypes = (
        [vp] * 9 + [ci] * 6 + [cf] * 10 + [ci] * 3 + [vp])
    lib.umr_raster_bwd.restype = ci
    lib.umr_cuda_error_string.argtypes = [ci]
    lib.umr_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


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
    """Bins of compute_raster_bins at image size S (any max_cover,
    mf_cap and entry_cap: the kernels read the entry count from
    al_fids); returns the entries per image."""
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


class _Raster(torch.autograd.Function):
    """Forward kernel + backward kernel (plain versions on the CPU).
    Gradients go to the faces and texels; the bins get none, and aggr and
    p2f are outputs without gradients. The backward reuses the forward's
    bins, rgba (at render size) and aggr."""

    @staticmethod
    def forward(ctx, fv, tex, al_fids, astarts, kw):
        if fv.is_cuda:
            rgba, aggr, p2f = _launch_fwd(
                fv, tex, (al_fids, astarts), kw["S"], kw["bg"],
                kw["sigma_val"], kw["dist_eps"], kw["gamma_val"],
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
            fv, tex, (al_fids, astarts), rgba, aggr, g_rgba, kw["S"],
            kw["sigma_val"], kw["dist_eps"], kw["gamma_val"], kw["mf_cap"],
            kw["mask_only"], kw["rgb_geom_detach"], kw["tex_grads"])
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
    mf_cap=256,
    need_p2f=False,
    mask_only=False,
    rgb_geom_detach=False,
    tex_grads=True,
    bins=None,
):
    """Rasterizer on the kernels' route, training-config subset (euclidean
    distance, product alpha, surface textures; softmax or hard RGB).

    face_vertices [B, F, 3, 3] float32; textures [B, F, T2, 3] or None.
    Same contract as ops/rasterize.py::soft_rasterize, plus mf_cap, the
    faces kept per 32x32 tile (as umr_tpu's soft_rasterize_pallas with
    tile_size=32, max_cover=4 and its default entry_cap); image_size is a
    multiple of 32. Differentiable with the reference CUDA backward's
    semantics (ops/rasterize_bwd.py): rgb_geom_detach sends rgb gradients
    to the texels only, tex_grads=False gives the texels none (for
    textures the caller does not differentiate), hard mode has no
    backward. bins: (al_fids, astarts) of compute_raster_bins at this
    image_size and mf_cap, shared by renders of the same projected faces;
    computed here when None (with MAX_COVER and the default entry cap;
    bins with larger caps drop fewer faces). Returns RasterOut; p2f is the per-face
    expected image coordinate under need_p2f (softmax; it carries no
    gradient, and a face's entries past mf_cap in a tile are dropped, as
    on the TPU), else zeros.
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
    if bins is None and face_vertices.is_cuda:
        bins = compute_raster_bins(face_vertices, S, TILE_SIZE, sigma_val,
                                   dist_eps, mf_cap, MAX_COVER)
    # the plain versions (CPU) render every face: they take no bins
    al_fids, astarts = (None, None) if bins is None else bins
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
