"""The port's PNG codec (png.py) against imageio, both ways: grey, RGB
and RGBA images, odd widths, files that imageio (Pillow) wrote, and
files with each of the five scanline filters and the image data split
over several IDAT chunks. The demo reads and writes through it. Exactly
equal pixels."""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from umr_tpu_torch import png
from umr_tpu_torch.config import Config
from umr_tpu_torch.experiments import demo
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.models import MeshNet, init_weights

SHAPES = [(5, 7), (9, 11, 3), (6, 13, 4), (1, 1), (17, 1, 3), (31, 33, 4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_written_files_read_back_by_imageio(tmp_path, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("shape", SHAPES + [(200, 301, 3), (64, 65)])
def test_imageio_files_read(tmp_path, shape):
    """Noise and smooth ramps: Pillow picks its filters per row."""
    rng = np.random.RandomState(len(shape))
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    ramp = (x * 3 + y * 5) % 256
    if len(shape) == 3:
        ramp = np.stack([(ramp + 40 * c) % 256 for c in range(shape[2])], -1)
    for img in (rng.randint(0, 256, shape, np.uint8), ramp.astype(np.uint8)):
        path = str(tmp_path / "b.png")
        imageio.imwrite(path, img)
        np.testing.assert_array_equal(png.read_png(path), img)


def _filtered_png(img, filters, n_idat):
    """A PNG of img [H,W,C] whose row y uses filter filters[y % len], its
    data cut into n_idat IDAT chunks (the encoder of the PNG spec)."""
    H, W, C = img.shape
    raw = bytearray()
    prev = np.zeros(W * C, np.int64)
    for y in range(H):
        line = img[y].reshape(-1).astype(np.int64)
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(C, np.int64), line[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw.append(kind)
        raw += ((line - pred) % 256).astype(np.uint8).tobytes()
        prev = line
    data = zlib.compress(bytes(raw))
    cut = np.linspace(0, len(data), n_idat + 1).astype(int)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                                     color, 0, 0, 0))
    for a, b in zip(cut[:-1], cut[1:]):
        out += chunk(b"IDAT", data[a:b])
    return out + chunk(b"IEND", b"")


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_every_filter_and_split_idat(tmp_path, channels):
    img = np.random.RandomState(channels).randint(
        0, 256, (11, 9, channels), np.uint8)
    data = _filtered_png(img, [0, 1, 2, 3, 4, 4, 3, 1], n_idat=3)
    path = tmp_path / "c.png"
    path.write_bytes(data)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(png.decode_png(data), want)
    np.testing.assert_array_equal(imageio.imread(path), want)


def test_refuses_what_it_does_not_read(tmp_path):
    with pytest.raises(TypeError):
        png.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((2, 2, 2), np.uint8))
    path = str(tmp_path / "d.png")
    imageio.imwrite(path, np.zeros((4, 4), np.uint16))
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        png.read_png(path)
    jpg = str(tmp_path / "e.jpg")
    imageio.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="JPEG"):
        png.read_image(jpg)


def test_demo_run_reads_and_writes_png(tmp_path):
    """demo.run on a PNG input: the panel and the mesh's atlas are PNG
    files imageio reads; a JPEG input raises, naming the format."""
    template = build_template(2, 1, 2)
    model = init_weights(MeshNet(template, input_size=32, nz_feat=16,
                                 z_dim=8, num_hypo_cams=2),
                         torch.Generator().manual_seed(0))
    pth = str(tmp_path / "pred_net.pth")
    torch.save(model.state_dict(), pth)
    src = str(tmp_path / "bird.png")
    rgba = np.random.RandomState(0).randint(0, 256, (40, 48, 4), np.uint8)
    imageio.imwrite(src, rgba)
    cfg = Config(image_size=32, subdivide=2, tex_size=2, nz_feat=16, z_dim=8,
                 num_hypo_cams=2, anti_aliasing=False, model_path=pth,
                 img_path=src, out_path=str(tmp_path / "out")
                 ).sync_image_size()
    out = demo.run(cfg, device="cpu")
    panel = imageio.imread(out)
    assert panel.shape == (64, 96, 3) and panel.dtype == np.uint8
    np.testing.assert_array_equal(png.read_png(out), panel)
    assert imageio.imread(str(tmp_path / "out" / "pred_mesh.png")).ndim == 3
    jpg = str(tmp_path / "bird.jpg")
    imageio.imwrite(jpg, rgba[..., :3])
    with pytest.raises(NotImplementedError, match="JPEG"):
        demo.run(cfg.replace(img_path=jpg), device="cpu")


@pytest.mark.parametrize("channels", [1, 3])
def test_save_image_grid_matches_jax(tmp_path, channels):
    """visualizer.save_image_grid through the codec: the same pixels as
    the JAX package's (imageio) grid."""
    from umr_tpu.utils.visualizer import save_image_grid as jax_grid
    from umr_tpu_torch.visualizer import save_image_grid

    imgs = np.random.RandomState(channels).uniform(
        -0.1, 1.1, (3, 5, 7, channels)).astype(np.float32)
    save_image_grid(str(tmp_path / "t.png"), imgs)
    jax_grid(str(tmp_path / "j.png"), imgs)
    got = imageio.imread(tmp_path / "t.png")
    assert got.shape == (5, 21, 3)
    np.testing.assert_array_equal(got, imageio.imread(tmp_path / "j.png"))
