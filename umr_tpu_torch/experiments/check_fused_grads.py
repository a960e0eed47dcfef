"""The fused render's gradient routing (port of tools/check_fused_grads.py):
one render with rgb_geom_detach=True (one forward and one backward
kernel) must give
  - vertex gradients == the mask-only render's (the alpha path only),
  - texture gradients == the render with the geometry detached,
the reference's two-render formulation (ref train_s2.py:226,248), each
within 1e-5 + 1e-3 x the largest |gradient| of the two-render side.

The scene is the JAX tool's: template (2, 1, 4), B=2 perturbed meshes,
64^2, the ambient-only renderer, upstream gradients from
default_rng(0). The renders take the kernels' route (impl="kernel"): on
the card the CUDA kernels, which raise where they cannot build or run
(no fallback); on the CPU (--device cpu) their plain versions. The
kernels' tile is 32 x 32 (the JAX tool ran its Pallas kernel at 16).

  python -m umr_tpu_torch.experiments.check_fused_grads [--device cpu]

Exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def run(device=None):
    """The check on `device` (the card unless "cpu"): returns dict(dv, sv,
    dt, st, ok): the largest vertex and texture gradient differences and
    the two-render side's largest |gradient| (their scales)."""
    from ..config import resolve_device
    from ..mesh import build_template
    from ..renderer import SoftRenderer

    dev = resolve_device(device)
    tpl = build_template(2, 1, 4)
    faces = torch.as_tensor(tpl.faces, device=dev)
    rng = np.random.default_rng(0)
    B, F = 2, tpl.faces.shape[0]
    verts = torch.as_tensor(
        (tpl.verts[None].repeat(B, 0)
         + 0.02 * rng.standard_normal((B,) + tpl.verts.shape)).astype(
             np.float32), device=dev)
    cams = np.stack([[0.9, 0.05, -0.02, 1.0, 0.1, 0.05, 0.02]] * B)
    cams[:, 3:] /= np.linalg.norm(cams[:, 3:], axis=1, keepdims=True)
    cams = torch.as_tensor(cams.astype(np.float32), device=dev)
    tex = torch.as_tensor(rng.random((B, F, 16, 3)).astype(np.float32),
                          device=dev)
    r_amb = SoftRenderer(image_size=64, anti_aliasing=False,
                         impl="kernel").ambient_light_only()
    g_rgb = torch.as_tensor(rng.standard_normal((B, 64, 64, 3)).astype(
        np.float32), device=dev)
    g_a = torch.as_tensor(rng.standard_normal((B, 64, 64)).astype(
        np.float32), device=dev)

    def grads(loss_fn):
        v = verts.clone().requires_grad_()
        t = tex.clone().requires_grad_()
        loss_fn(v, t).backward()
        return v.grad, t.grad

    def fused(v, t):
        out = r_amb.render(v, faces, cams, t, rgb_geom_detach=True)
        return ((out.rgba[..., 3] * g_a).sum()
                + (out.rgba[..., :3] * g_rgb).sum())

    def two_pass(v, t):
        m = r_amb.render(v, faces, cams, mask_only=True)
        o = r_amb.render(v.detach(), faces, cams, t)
        return ((m.rgba[..., 3] * g_a).sum()
                + (o.rgba[..., :3] * g_rgb).sum())

    gv_f, gt_f = grads(fused)
    gv_2, gt_2 = grads(two_pass)
    dv = float((gv_f - gv_2).abs().max())
    sv = float(gv_2.abs().max())
    dt = float((gt_f - gt_2).abs().max())
    st = float(gt_2.abs().max())
    ok = dv <= 1e-5 + 1e-3 * sv and dt <= 1e-5 + 1e-3 * st
    return dict(dv=dv, sv=sv, dt=dt, st=st, ok=ok)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    r = run(args.device)
    print(f"verts grad: max|diff|={r['dv']:.3e} (scale {r['sv']:.3e})")
    print(f"tex   grad: max|diff|={r['dt']:.3e} (scale {r['st']:.3e})")
    print("OK" if r["ok"] else "MISMATCH")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
