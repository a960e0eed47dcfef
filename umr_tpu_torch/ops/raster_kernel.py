"""Wrapper of the hand-written CUDA forward rasterizer
(csrc/raster_fwd.cu, which replaces umr_tpu/ops/raster_kernel.py::_fwd_kernel).

On a CUDA tensor, soft_rasterize_fwd bins the faces (ops/raster_bins.py)
and launches the kernel; it never falls back. On a CPU tensor it runs the
kernel's plain version, ops/rasterize.py::soft_rasterize.

The kernel is built at first use with nvcc into umr_tpu_torch/build/, as a
shared library with a plain C interface loaded through ctypes, keyed by a
hash of the sources and flags. A missing nvcc or a failed build raises.
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

from .raster_bins import compute_raster_bins, entry_dims
from .rasterize import EPS, FAR, NEAR, RasterOut, soft_rasterize, threshold_of

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# --fmad=false: no FMA contraction, so the per-pair arithmetic rounds as the
# plain version's does (see the note in csrc/raster_fwd.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# the kernel's tile (32x32 pixels, 256 threads of 4 pixels), and the
# bins' bound on the tiles a face's bbox spans per axis
TILE_SIZE = 32
MAX_COVER = 4

# kernel launches made by soft_rasterize_fwd; callers reset and read it
LAUNCHES = 0

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


def build():
    """Compile csrc/*.cu (once per source hash) and load the library."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libumr_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[str(s) for s in sources if s.suffix == ".cu"]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.umr_raster_fwd.argtypes = (
        [vp] * 6 + [ci] * 6 + [cf] * 14 + [ci] * 2 + [vp])
    lib.umr_raster_fwd.restype = ci
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
):
    """Forward rasterizer, training-config subset (euclidean distance,
    product alpha, surface textures; softmax or hard RGB).

    face_vertices [B, F, 3, 3] float32; textures [B, F, T2, 3] or None.
    Same contract as ops/rasterize.py::soft_rasterize, plus mf_cap, the
    faces kept per 32x32 tile (as umr_tpu's soft_rasterize_pallas with
    tile_size=32, max_cover=4 and its default entry_cap). image_size is a
    multiple of 32. Returns RasterOut; p2f is zeros (need_p2f=True raises:
    p2f is a training output, not yet in the kernel).
    """
    global LAUNCHES
    if need_p2f:
        raise NotImplementedError(
            "need_p2f=True: the forward rasterizer does not write p2f yet")
    if not face_vertices.is_cuda:
        return soft_rasterize(
            face_vertices, textures, image_size=image_size,
            background_color=background_color, sigma_val=sigma_val,
            dist_eps=dist_eps, gamma_val=gamma_val,
            aggr_func_rgb=aggr_func_rgb, mask_only=mask_only)
    if aggr_func_rgb not in ("softmax", "hard"):
        raise ValueError(f"aggr_func_rgb={aggr_func_rgb!r}")
    hard = aggr_func_rgb == "hard"
    B, F = face_vertices.shape[:2]
    S = int(image_size)
    if S % TILE_SIZE:
        raise ValueError(f"image_size={S} is not a multiple of the kernel's "
                         f"{TILE_SIZE}-pixel tile")
    dev = face_vertices.device
    if textures is None:
        textures = torch.ones((B, F, 1, 3), dtype=face_vertices.dtype,
                              device=dev)
    T2 = textures.shape[2]
    _check(face_vertices, "face_vertices", (B, F, 3, 3), torch.float32, dev)
    _check(textures, "textures", (B, F, T2, 3), torch.float32, dev)

    n_tiles = (S // TILE_SIZE) ** 2
    E_al, _ = entry_dims(F, n_tiles, MAX_COVER, mf_cap)
    al_fids, astarts = compute_raster_bins(face_vertices, S, TILE_SIZE,
                                           sigma_val, dist_eps, mf_cap,
                                           MAX_COVER)
    _check(al_fids, "al_fids", (B, E_al), torch.int32, dev)
    _check(astarts, "astarts", (B, n_tiles + 1), torch.int32, dev)

    threshold, margin = threshold_of(sigma_val, dist_eps)
    bg = list(background_color)[:3] + [0.0] * (3 - len(background_color))
    rgba = torch.empty((B, S, S, 4), dtype=torch.float32, device=dev)
    aggr = torch.empty((B, 2, S, S), dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.umr_raster_fwd(
            face_vertices.data_ptr(), textures.data_ptr(),
            al_fids.data_ptr(), astarts.data_ptr(), rgba.data_ptr(),
            aggr.data_ptr(),
            B, F, S, T2, E_al, int(mf_cap),
            NEAR, FAR, 1.0 / (FAR - NEAR), EPS, 1.0 / sigma_val,
            1.0 / gamma_val, threshold, margin,
            float(np.exp(EPS / gamma_val)), 1e-5, 1.0 - 1e-5, *bg,
            int(hard), int(bool(mask_only)), stream)
    if err:
        raise RuntimeError("raster_fwd launch failed: "
                           + lib.umr_cuda_error_string(err).decode())
    LAUNCHES += 1
    return RasterOut(rgba=rgba, p2f=face_vertices.new_zeros((B, F, 2)),
                     aggr=aggr)
