"""The work a training step needs, counted from the configuration's shapes
and the renders' geometry, the same for any implementation: the
operations of its convolutions and linear layers (forward, and backward
as far as the step needs it: weight gradients of trained layers, input
gradients where a gradient flows on), and the operations and bytes of
each soft or hard render, from the (pixel, face) pairs in each face's
bbox widened by the distance margin. Recomputed work is not counted.

Peaks are the H100 SXM data sheet's: 67 TFLOP/s in float32 outside the
tensor cores (an FMA counted as two) and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

import math

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# operations a (pixel, face) pair needs, by the branch of the soft
# rasterizer's equations it reaches (SoftRas's forward and backward, one
# per add, multiply, divide, compare, select, exponential, floor):
OPS_BOX = 4        # the widened-bbox test
OPS_DIST = 134     # barycentrics 12, the three edges' nearest points 99,
                   # the inside test 6, the nearest edge 13, the squared
                   # distance and its threshold test 4
OPS_FRAG = 26      # past the threshold: sign and sigmoid 7, clipped
                   # barycentrics and depth 19
OPS_TEXEL = 18     # the nearest texel's index
OPS_FOOT = 15      # backward: the nearest point's weights
OPS_FWD_PASS = 4   # forward past the threshold: alpha 2, depth test 2
OPS_FWD_Z = 14     # forward, depth in range: softmax weight and sum 8,
                   # colour sums 6
OPS_FWD_HARD = 12  # hard forward past the threshold: the [0, 1] test 11,
                   # the depth compare 1
OPS_BWD_PASS = 2   # backward past the threshold: the depth gate
OPS_BWD_Z = 30     # backward, depth in range: the alpha term and the x, y
                   # chain
OPS_BWD_SOFT = 6   # its softmax weight, where texels or depths get grads
OPS_BWD_TEX = 7    # its texel gradient
OPS_BWD_ZLANE = 26  # its colour term and depth gradient
OPS_P2F = 5        # forward with p2f: contrib * (gx, gy) and their sums


def conv_macs(h_out, w_out, c_out, c_in, k):
    return h_out * w_out * c_out * c_in * k * k


def conv_out(h, k, s, p):
    return (h + 2 * p - k) // s + 1


class Layers:
    """Layers as (multiply-adds per sample, trained, input gradient)."""

    def __init__(self):
        self.rows = []

    def add(self, macs, trained=True, igrad=True):
        self.rows.append((macs, trained, igrad))

    def linear(self, n_in, n_out, **kw):
        self.add(n_in * n_out, **kw)

    def flops(self, n, n_igrad=None, n_fwd=None):
        """Operations for n samples: forward (on n_fwd, default n), weight
        gradients of trained layers and input gradients (on n_igrad,
        default n)."""
        n_igrad = n if n_igrad is None else n_igrad
        n_fwd = n if n_fwd is None else n_fwd
        return sum(2 * m * (n_fwd + (n if tr else 0) + (n_igrad if ig else 0))
                   for m, tr, ig in self.rows)


def resnet18(layers, S):
    """The ResNet-18 trunk at S x S (its first conv takes no input
    gradient: the image needs none)."""
    h = conv_out(S, 7, 2, 3)
    layers.add(conv_macs(h, h, 64, 3, 7), igrad=False)
    h = conv_out(h, 3, 2, 1)
    c_in = 64
    for planes, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        for block in range(2):
            s = stride if block == 0 else 1
            h_out = conv_out(h, 3, s, 1)
            layers.add(conv_macs(h_out, h_out, planes, c_in, 3))
            layers.add(conv_macs(h_out, h_out, planes, planes, 3))
            if s != 1 or c_in != planes:
                layers.add(conv_macs(h_out, h_out, planes, c_in, 1))
            h, c_in = h_out, planes
    return h


def mesh_net(cfg, stage, num_output, uv_hw):
    """The model's layers per sample: trunk, encoder, heads, texture flow."""
    L = Layers()
    S, nz, z = cfg["image_size"], cfg["nz_feat"], cfg["z_dim"]
    fmap = resnet18(L, S)
    if fmap >= 2:
        out = conv_out(fmap, 4, 2, 1)
        L.add(conv_macs(out, out, 256, 512, 4))
    else:
        out = fmap
        L.add(conv_macs(out, out, 256, 512, 1))
    L.linear(256 * out * out, nz)
    L.linear(nz, nz)
    for _ in range(2):                       # mean_fc, logvar_fc
        L.linear(nz, nz)
        L.linear(nz, z)
    if stage == 2:
        L.linear(z, num_output * 3)
        L.linear(nz, nz)                     # the hypotheses' shared fc
        L.linear(nz, nz)
        for _ in range(cfg["num_hypo_cams"]):
            L.linear(nz, nz)
            L.linear(nz, nz)
            for n_out in (4, 1, 1, 2):       # quat, prob, scale, trans
                L.linear(nz, n_out)
    else:
        widths = [z, z, 2 * z, 4 * z, 8 * z, num_output * 3]
        for a, b in zip(widths[:-1], widths[1:]):
            L.linear(a, b)
        for n_out in (4, 1, 2):
            L.linear(nz, n_out)
    H, W = uv_hw
    n_up = min(5, int(math.log2(H)))
    fh, fw = H // 2 ** n_up, W // 2 ** n_up
    L.linear(nz, 256 * fh * fw)
    L.linear(256 * fh * fw, 256 * fh * fw)
    c = 256
    for _ in range(n_up):
        c_out = c // 2 if c // 2 >= 8 else c
        fh, fw = 2 * fh, 2 * fw
        L.add(fh * fw * c_out * c * 9)       # upconv
        L.add(fh * fw * c_out * c_out * 9)   # conv block
        c = c_out
    L.add(fh * fw * 2 * c * 9)
    return L


def lpips_alex(S):
    """LPIPS-Alex's convs per image pair side (frozen: no weight grads)."""
    L = Layers()
    h = S
    for i, (c_in, c_out, k, s, p) in enumerate(
            [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
             (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]):
        if i in (1, 2):
            h = conv_out(h, 3, 2, 0)
        h = conv_out(h, k, s, p)
        L.add(conv_macs(h, h, c_out, c_in, k), trained=False)
    return L


def discriminator(S, in_dim):
    """The mask discriminator; its first conv's input gradient is needed
    for the fake images only (step_flops)."""
    L = Layers()
    chans = (in_dim, 32, 64, 32, 32)
    h = S
    for i in range(4):
        h = conv_out(h, 3, 2, 1)
        L.add(conv_macs(h, h, chans[i + 1], chans[i], 3), igrad=i > 0)
    L.add(conv_macs(h, h, 1, 32, 1))
    L.linear(h * h, 1)
    return L


def step_flops(cfg, stage, batch, num_output, uv_hw):
    """{part: operations} of one step's convolutions and linear layers."""
    S = cfg["image_size"]
    K = cfg["num_hypo_cams"] if stage == 2 else 1
    disc = discriminator(S, 3 if stage == 2 else 1)
    first = disc.rows[0]
    return {
        "model": mesh_net(cfg, stage, num_output, uv_hw).flops(batch),
        # both images of each pair forward, input gradients on the render's
        "lpips": lpips_alex(S).flops(batch * K, n_fwd=2 * batch * K),
        "disc": disc.flops(2 * batch)
                + 2 * first[0] * batch,       # the fake half's input grads
    }


def render_work(counts, n_images, S, F, T2, hard=False, mask_only=False,
                need_p2f=False, backward=None):
    """(operations, bytes) of one render at S x S, from its pair_counts
    (pairs in the widened bbox, past the threshold, with depth in range).
    backward: None for the forward, else (texel gradients, depth
    gradients) of its backward."""
    box, passed, in_depth = counts
    ops = box * (OPS_BOX + OPS_DIST) + passed * OPS_FRAG
    inputs = 4 * n_images * F * (9 + T2 * 3)
    img = 4 * n_images * S * S * (4 + 2)              # rgba, aggr
    if backward is None:
        ops += passed * OPS_FWD_PASS
        if not mask_only:
            ops += passed * OPS_TEXEL
        ops += passed * OPS_FWD_HARD if hard else in_depth * OPS_FWD_Z
        if need_p2f:
            ops += in_depth * OPS_P2F
            img += 4 * n_images * F * 2
        return ops, inputs + img
    want_tex, want_z = backward
    rgb = want_tex or want_z
    ops += (passed * (OPS_FOOT + OPS_BWD_PASS + rgb * OPS_TEXEL)
            + in_depth * (OPS_BWD_Z + rgb * OPS_BWD_SOFT
                          + want_tex * OPS_BWD_TEX
                          + want_z * OPS_BWD_ZLANE))
    # reads the faces, texels, rgba, aggr and the rgba cotangent; writes
    # the face and texel gradients
    return ops, 2 * inputs + img + 4 * n_images * S * S * 4


def least_seconds(ops, nbytes):
    """(the least time, "operations" or "bytes": which bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
