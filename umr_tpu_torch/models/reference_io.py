"""Key map between the JAX package's flax parameter paths and the
reference torch state_dict keys, copied as data from
umr_tpu/models/reference_io.py::build_key_map (a test pins the two equal).

Each entry is (flax_path_tuple, torch_key, transform). The port's module
names are the torch keys, so the map carries flax weights into the port.

use_texture=False drops the texture predictor's rows. Stage 2's single camera
(multiple_cam_hypo=False), which the JAX package's map does not cover,
maps its `Camera` to the reference's cub_mesh.py names
(cam_predictor.fc_layer.*, cam_predictor.{quat,scale,trans}_predictor.*,
cam_predictor.prob_predictor). az_ele_quat keeps every row (its unused
linear layer is quat_predictor.pred_layer, 3 wide).
"""

from __future__ import annotations

import numpy as np

# transforms: how a torch tensor becomes a flax leaf
T_LINEAR = "linear"     # [out,in] <-> [in,out]
T_CONV = "conv"         # [O,I,kh,kw] <-> [kh,kw,I,O]
T_COPY = "copy"


def _fc_stack(flax_prefix, torch_prefix, nlayers, use_bn=True):
    out = []
    for i in range(nlayers):
        out += [
            ((*flax_prefix, f"FC_{i}", "Dense_0", "kernel"),
             f"{torch_prefix}.{i}.0.weight", T_LINEAR),
            ((*flax_prefix, f"FC_{i}", "Dense_0", "bias"),
             f"{torch_prefix}.{i}.0.bias", T_COPY),
        ]
        if use_bn:
            out += [
                ((*flax_prefix, f"FC_{i}", "BatchNorm_0", "scale"),
                 f"{torch_prefix}.{i}.1.weight", T_COPY),
                ((*flax_prefix, f"FC_{i}", "BatchNorm_0", "bias"),
                 f"{torch_prefix}.{i}.1.bias", T_COPY),
            ]
    return out


def _bn_stats(flax_prefix, torch_prefix):
    return [
        ((*flax_prefix, "mean"), f"{torch_prefix}.running_mean", T_COPY),
        ((*flax_prefix, "var"), f"{torch_prefix}.running_var", T_COPY),
    ]


def _fc_stack_stats(flax_prefix, torch_prefix, nlayers):
    out = []
    for i in range(nlayers):
        out += _bn_stats((*flax_prefix, f"FC_{i}", "BatchNorm_0"),
                         f"{torch_prefix}.{i}.1")
    return out


def _linear(flax_prefix, torch_prefix):
    return [
        ((*flax_prefix, "kernel"), f"{torch_prefix}.weight", T_LINEAR),
        ((*flax_prefix, "bias"), f"{torch_prefix}.bias", T_COPY),
    ]


def resnet_maps(fp, tp):
    """(params_map, stats_map) of the ResNet-18 trunk under flax prefix fp
    and torch prefix tp."""
    pm = [((*fp, "conv1", "kernel"), f"{tp}.conv1.weight", T_CONV)]
    pm += [((*fp, "bn1", "scale"), f"{tp}.bn1.weight", T_COPY),
           ((*fp, "bn1", "bias"), f"{tp}.bn1.bias", T_COPY)]
    sm = _bn_stats((*fp, "bn1"), f"{tp}.bn1")
    for li in range(1, 5):
        for bi in range(2):
            f = (*fp, f"layer{li}_{bi}")
            t = f"{tp}.layer{li}.{bi}"
            for c in ("conv1", "conv2"):
                pm.append(((*f, c, "kernel"), f"{t}.{c}.weight", T_CONV))
            for b in ("bn1", "bn2"):
                pm += [((*f, b, "scale"), f"{t}.{b}.weight", T_COPY),
                       ((*f, b, "bias"), f"{t}.{b}.bias", T_COPY)]
                sm += _bn_stats((*f, b), f"{t}.{b}")
            if li > 1 and bi == 0:
                pm += [((*f, "downsample_conv", "kernel"),
                        f"{t}.downsample.0.weight", T_CONV),
                       ((*f, "downsample_bn", "scale"),
                        f"{t}.downsample.1.weight", T_COPY),
                       ((*f, "downsample_bn", "bias"),
                        f"{t}.downsample.1.bias", T_COPY)]
                sm += _bn_stats((*f, "downsample_bn"), f"{t}.downsample.1")
    return pm, sm


def _encoder_maps():
    pm, sm = resnet_maps(("encoder", "resnet"), "encoder.resnet_conv.resnet")
    pm += [
        (("encoder", "enc_conv1", "Conv_0", "kernel"),
         "encoder.enc_conv1.0.weight", T_CONV),
        (("encoder", "enc_conv1", "Conv_0", "bias"),
         "encoder.enc_conv1.0.bias", T_COPY),
        (("encoder", "enc_conv1", "BatchNorm_0", "scale"),
         "encoder.enc_conv1.1.weight", T_COPY),
        (("encoder", "enc_conv1", "BatchNorm_0", "bias"),
         "encoder.enc_conv1.1.bias", T_COPY),
    ]
    sm += _bn_stats(("encoder", "enc_conv1", "BatchNorm_0"),
                    "encoder.enc_conv1.1")
    pm += _fc_stack(("encoder", "enc_fc"), "encoder.enc_fc", 2)
    sm += _fc_stack_stats(("encoder", "enc_fc"), "encoder.enc_fc", 2)
    for head in ("mean_fc", "logvar_fc"):
        pm += _linear(("encoder", f"{head}_0"), f"encoder.{head}.0")
        pm += _linear(("encoder", f"{head}_1"), f"encoder.{head}.2")
    return pm, sm


def _texture_maps(n_upconv=5):
    pm = _fc_stack(("texture_predictor", "enc"), "texture_predictor.enc", 2)
    sm = _fc_stack_stats(("texture_predictor", "enc"),
                         "texture_predictor.enc", 2)
    for k in range(n_upconv):
        # upconv2d = Sequential(Upsample, ReflectionPad, Conv, LeakyReLU)
        up = ("texture_predictor", "decoder", f"UpConvBlock_{k}", "Conv_0")
        cb = ("texture_predictor", "decoder", f"ConvBlock_{k}")
        pm += [
            ((*up, "kernel"),
             f"texture_predictor.decoder.{2 * k}.2.weight", T_CONV),
            ((*up, "bias"),
             f"texture_predictor.decoder.{2 * k}.2.bias", T_COPY),
            ((*cb, "Conv_0", "kernel"),
             f"texture_predictor.decoder.{2 * k + 1}.0.weight", T_CONV),
            ((*cb, "Conv_0", "bias"),
             f"texture_predictor.decoder.{2 * k + 1}.0.bias", T_COPY),
            ((*cb, "BatchNorm_0", "scale"),
             f"texture_predictor.decoder.{2 * k + 1}.1.weight", T_COPY),
            ((*cb, "BatchNorm_0", "bias"),
             f"texture_predictor.decoder.{2 * k + 1}.1.bias", T_COPY),
        ]
        sm += _bn_stats((*cb, "BatchNorm_0"),
                        f"texture_predictor.decoder.{2 * k + 1}.1")
    pm += [
        (("texture_predictor", "decoder", "Conv_0", "kernel"),
         f"texture_predictor.decoder.{2 * n_upconv}.weight", T_CONV),
        (("texture_predictor", "decoder", "Conv_0", "bias"),
         f"texture_predictor.decoder.{2 * n_upconv}.bias", T_COPY),
    ]
    return pm, sm


def _camera_maps(flax_prefix, torch_prefix):
    """One `Camera` head: its fc stack and its four linear heads."""
    pm = _fc_stack((*flax_prefix, "fc_layer"), f"{torch_prefix}.fc_layer", 2)
    sm = _fc_stack_stats((*flax_prefix, "fc_layer"),
                         f"{torch_prefix}.fc_layer", 2)
    pm += _linear((*flax_prefix, "quat", "Dense_0"),
                  f"{torch_prefix}.quat_predictor.pred_layer")
    pm += _linear((*flax_prefix, "prob"), f"{torch_prefix}.prob_predictor")
    pm += _linear((*flax_prefix, "scale", "Dense_0"),
                  f"{torch_prefix}.scale_predictor.pred_layer")
    pm += _linear((*flax_prefix, "trans", "Dense_0"),
                  f"{torch_prefix}.trans_predictor.pred_layer")
    return pm, sm


def build_key_map(stage=2, num_cams=8, n_upconv=5, use_texture=True,
                  multiple_cam_hypo=True):
    """Returns (params_map, stats_map, buffers_map, template_map): lists of
    (flax_path_tuple, torch_key, transform) of the stage's model in the
    given variant."""
    pm, sm = _encoder_maps()
    if use_texture:
        tpm, tsm = _texture_maps(n_upconv)
        pm += tpm
        sm += tsm
    buffers = []

    if stage == 2:
        pm += _linear(("shape_predictor", "Dense_0"),
                      "shape_predictor.pred_layer")
        cp = "cam_predictor"
        if not multiple_cam_hypo:
            cpm, csm = _camera_maps((cp,), cp)
            pm += cpm
            sm += csm
        else:
            pm += _fc_stack((cp, "fc"), f"{cp}.fc", 2, use_bn=False)
            pm += _linear((cp, "scale_predictor", "Dense_0"),
                          f"{cp}.scale_predictor.pred_layer")
            pm += _linear((cp, "trans_predictor", "Dense_0"),
                          f"{cp}.trans_predictor.pred_layer")
            pm += _linear((cp, "prob_predictor"), f"{cp}.prob_predictor")
            pm += _linear((cp, "quat_predictor", "Dense_0"),
                          f"{cp}.quat_predictor.pred_layer")
            for i in range(num_cams):
                cpm, csm = _camera_maps((cp, f"camera_{i}"),
                                        f"{cp}.camera_predictor.{i}")
                pm += cpm
                sm += csm
            buffers = [
                (("cam_predictor", "cam_biases"),
                 "cam_predictor.cam_biases", T_COPY),
            ]
    else:
        # stage-1 MLP shape head (ref: cub_mesh_s1.py:157-180)
        for j, ti in enumerate((0, 2, 4, 6, 8)):
            pm += _linear(("shape_predictor", f"Dense_{j}"),
                          f"shape_predictor.pred_layer.{ti}")
        pm += _linear(("quat_predictor", "Dense_0"),
                      "quat_predictor.pred_layer")
        pm += _linear(("scale_predictor", "Dense_0"),
                      "scale_predictor.pred_layer")
        pm += _linear(("trans_predictor", "Dense_0"),
                      "trans_predictor.pred_layer")

    template = [(("mean_v",), "mean_v", T_COPY)]
    return pm, sm, buffers, template


def to_torch_layout(arr, transform):
    """A flax leaf -> the torch tensor layout of its key."""
    arr = np.asarray(arr)
    if transform == T_LINEAR:
        return arr.T
    if transform == T_CONV:
        return np.transpose(arr, (3, 2, 0, 1))
    return arr


def to_flax_layout(arr, transform):
    """A torch tensor's array -> the flax leaf layout of its key (the
    inverse of to_torch_layout)."""
    arr = np.asarray(arr)
    if transform == T_LINEAR:
        return np.transpose(arr, (1, 0))
    if transform == T_CONV:
        return np.transpose(arr, (2, 3, 1, 0))
    return arr
