"""umr_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of umr_tpu.

It imports torch and never jax, flax, optax, orbax, absl or the JAX
package umr_tpu (whose __init__ imports jax where it is installed). The
host-side numpy code the slice needs is copied, and tests pin each copy
equal to its original.

Port module -> JAX counterpart (umr_tpu/...):
  config.py                  config.py::Config (without the absl bridge);
                             beside it the entry points' device rule,
                             model scope and ResNet input normalisation
  mesh.py                    mesh/ (icosphere, symmetry, uv, template with
                             laplacian and flatten_idx)
  data/synthetic.py          data/synthetic.py::synthetic_batch
  data/cub.py, data/loader.py
                             data/cub.py (CUBDataset, CUBTestPairDataset,
                             data_loader, cub_test_pair_dataloader),
                             data/loader.py (threaded DataLoader, collate)
  native.py, csrc/edt.cpp    native.py, native/edt.cpp (the EDT barrier,
                             g++ at first use, ctypes; no scipy fallback)
  data/synthetic_category.py data/synthetic_category.py (the bird category
                             rendered through the port's renderer;
                             CategoryLoader with device_data, PairLoader)
  obj_io.py                  utils/obj_io.py::save_obj (surface and vertex
                             textures; the atlas through png.py)
  png.py                     the 8-bit PNG files imageio reads and writes
                             (zlib only: the card's machine has no imageio)
  jpeg.py                    imageio's JPEG reading: nvJPEG on the card
                             (ctypes) with libjpeg's chroma upsampling and
                             colour conversion
  image.py                   utils/image.py (the crop chain, resize_img
                             through torch's bilinear for cv2's, the EDT,
                             colouring, part points, the drawing helpers)
  visualizer.py              utils/visualizer.py (green, red, Visualizer,
                             save_image_grid)
  ops/quaternion.py          ops/quaternion.py (incl. ang2quat, rotate_cam,
                             the numpy quat_from_matrix_np, mirror_quat_np)
  ops/projection.py          ops/projection.py
  ops/grid_sample.py         ops/grid_sample.py (F.grid_sample, align_corners;
                             identity_grid)
  ops/rasterize.py           ops/rasterize.py, forward, training subset;
                             the forward kernel's plain version
  ops/rasterize_bwd.py       ops/raster_kernel_bwd.py's math in plain torch:
                             the backward kernel's plain version
  ops/raster_bins.py         ops/rasterize_binned.py::_face_tile_cover,
                             ops/raster_kernel.py::compute_raster_bins;
                             full_raster_bins has no counterpart
  csrc/raster_bins.cu        full_raster_bins on the card (new)
  csrc/raster_fwd.cu         ops/raster_kernel.py::_fwd_kernel (Pallas)
  csrc/raster_bwd.cu         ops/raster_kernel_bwd.py::_bwd_kernel (Pallas)
  csrc/raster_common.cuh     ops/raster_kernel.py::_pair_math
  ops/raster_kernel.py       ops/raster_kernel.py::soft_rasterize_pallas,
                             _pallas_raster_vjp (build, launch, autograd)
  renderer/soft_renderer.py  renderer/soft_renderer.py
  models/net_blocks.py       models/net_blocks.py
  models/resnet.py           models/resnet.py
  models/heads.py            models/heads.py (stage-2 heads)
  models/mesh_net.py         models/mesh_net.py::MeshNet, symmetrize
  models/lpips.py            models/lpips.py::LPIPSAlex
  models/discriminator.py    models/discriminator.py (GRL as a Function)
  models/reference_io.py     models/reference_io.py::build_key_map (data)
  models/weights.py          models/weight_io.py (npz),
                             training/checkpoints.py::load_pth, flax ->
                             torch for the discriminator and LPIPS
  losses/losses.py           losses/losses.py
  losses/composite.py        losses/composite.py
  training/steps.py          training/steps.py::build_s2_step, build_s1_step
  training/trainer.py        training/trainer.py (the loop, lagged drain,
                             cadences, auto-resume, stage budget, visuals)
  training/visuals.py        training/visuals.py
  training/checkpoints.py    training/checkpoints.py (torch.save for Orbax)
  experiments/test_iou.py    experiments/test_iou.py
  experiments/demo.py        experiments/demo.py
  experiments/train_s1.py    experiments/train_s1.py
  experiments/train_s2.py    experiments/train_s2.py (load_semantic_template)
  experiments/avg_uv.py      experiments/avg_uv.py
  experiments/test_kp.py     experiments/test_kp.py
  experiments/synthetic_parity.py, extend_s2.py, eval_kp_pairs.py
                             tools/synthetic_parity.py, extend_s2.py,
                             eval_kp_pairs.py (the synthetic curriculum)
  cli.py                     config.py::define_flags (argparse, same names)
  parallel/mesh.py           parallel/mesh.py's data parallelism (make_mesh,
                             shard_batch, replicate) over torch.distributed,
                             with spawn and the entry points' launch; the
                             global BatchNorm in models/net_blocks.py;
                             make_mesh_2d
  parallel/tensor.py         parallel/mesh.py's tensor parallelism
                             (param_partition_specs, shard_state,
                             tensor_parallel_step)
  experiments/dryrun_multichip.py, soak_train.py, check_fused_grads.py
                             __graft_entry__.py::dryrun_multichip,
                             tools/soak_train.py, tools/check_fused_grads.py
  tracing.py                 the port's own (no counterpart): spans (a
                             profiler range, host seconds, records on the
                             trace's clock) and counters

Parity traps the port reproduces:
  * heads.py: the 1x1 `enc_conv1` for inputs under 64 px; CHW flatten
    order of the encoder and texture features; VAE noise drawn at eval
    too; the hypothesis drawn from log(p + 1e-9); the dead scale-head
    flags (lr 1.0, bias 1.0 always).
  * net_blocks.py: LeakyReLU 0.2 with BN, 0.1 without, 0.01 in the VAE
    heads; bilinear 2x upsample with half-pixel centres
    (F.interpolate align_corners=False), equal to jax.image.resize at
    the borders too.
  * resnet.py: max-pool padded with -inf.
  * mesh_net.py: symmetrize mirrors the trailing num_sym vertices.
  * BatchNorm: flax momentum 0.9 is torch's 0.1, eps 1e-5; eval uses the
    running statistics.
  * rasterizer: |det| <= 1e-10 faces are culled; hard-mode ties go to the
    lowest face id; the main path's bins keep every face a tile reaches,
    where the TPU kernel's caps drop some (ops/raster_bins.py);
    compute_raster_bins truncates exactly as the TPU kernel's binning
    does.
  * backward (kernel and plain): the reference CUDA semantics, not the
    derivative: a pair whose depth is outside [near, far] gives no
    gradient at all (zgate), dA/dD = (1 - A) / max(1 - D, 1e-6), the exp
    argument masked before the exp; hard mode has no backward.
  * losses: TexCycle marks face id -1 (background) on the last face; the
    s2 cycle target is the hard render's p2f, all zeros; corr_loss's
    zero-weighted neck/back parts stay in the mean's denominator.
  * trainer: the GAN's real images lag one batch; a run resumed
    mid-epoch restarts that epoch's batches; a run cut by num_iter skips
    that epoch's end hook.
  * test_kp: the flow mode scales keypoints by 256 whatever the image
    size; so do --visualize's overlays and the part-consistency overlay.
  * CUB loader: the SCOPS part maps are read as they are, never cropped
    or resized; sample_prob splits the pixel index by % H and // W and
    divides by 256; mirroring flips the part map and permutes the
    keypoints after their x-flip; the crop chain runs in float64 to the
    end; the loader's threads share one RandomState, so with more than
    one worker the draws interleave.
"""

__version__ = "0.1.0"
