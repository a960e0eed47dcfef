"""The port's copies of the JAX package's host-side numpy code are pinned
equal to their originals: Config, the mesh template, synthetic batches,
the .obj export and reader, the image crop and resize the demo and the
CUB loader share (image.py), and the utilities no path calls: geometry,
the dense CRF, flow_to_rgb, compute_dt, compute_dt_barrier,
compute_edges2verts and symmetrize_np. The CLI parses the
JAX package's flag names.

Tolerances: exactly equal, except the resize (torch bilinear
against cv2's, both with half-pixel centres): atol 1e-6, and the identity
grid (torch's and XLA's linspace round a few points one ulp apart):
atol 2e-7 (reading 1.19e-7)."""

import dataclasses

import imageio.v2 as imageio
import numpy as np
import pytest

from umr_tpu import config as jconfig
from umr_tpu.data.synthetic import synthetic_batch as jax_batch
from umr_tpu.mesh import build_template as jax_template
from umr_tpu.utils import image as jimage
from umr_tpu.utils.obj_io import save_obj as jax_save_obj
from umr_tpu_torch import config as tconfig
from umr_tpu_torch import image
from umr_tpu_torch.cli import parse_config
from umr_tpu_torch.data import synthetic_batch
from umr_tpu_torch.mesh import build_template
from umr_tpu_torch.obj_io import save_obj


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(
        jconfig.Config)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(
        tconfig.Config)]
    assert tf == jf


@pytest.mark.parametrize("kw", [
    dict(image_size=64), dict(img_size=128), dict(symmetric=False),
    dict(workers=3), dict(only_mean_sym=True), dict(dataset="pascal"),
])
def test_config_sync_and_validate_match_jax(kw):
    j, t = jconfig.Config(**kw), tconfig.Config(**kw)
    assert (dataclasses.asdict(t.sync_image_size())
            == dataclasses.asdict(j.sync_image_size()))
    outcomes = []
    for c in (j, t):
        try:
            c.validate()
            outcomes.append(None)
        except (NotImplementedError, ValueError) as e:
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]


def test_cli_takes_the_jax_flag_names():
    cfg = parse_config(["--image_size=64", "--noanti_aliasing",
                        "--num_hypo_cams", "2", "--model_path", "m.pth"],
                       overrides=dict(batch_size=32))
    assert (cfg.image_size, cfg.img_size, cfg.anti_aliasing,
            cfg.num_hypo_cams, cfg.model_path, cfg.batch_size) == (
        64, 64, False, 2, "m.pth", 32)
    with pytest.raises(NotImplementedError):
        parse_config(["--symmetric=false"])


@pytest.mark.parametrize("subdivide,axis,tex_size", [(2, 1, 2), (3, 1, 6)])
def test_template_matches_jax(subdivide, axis, tex_size):
    j = jax_template(subdivide, axis, tex_size)
    t = build_template(subdivide, axis, tex_size)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (t.num_output, t.num_tex_faces, t.uv_image_size()) == (
        j.num_output, j.num_tex_faces, j.uv_image_size())


@pytest.mark.parametrize("with_dt", [False, True])
def test_synthetic_batch_matches_jax(with_dt):
    """dts_barrier: the port's native C++ EDT here, the JAX package's
    (umr_tpu.native.edt_barrier_batch) there; the same source built with
    other flags: atol 1e-6."""
    j = jax_batch(np.random.RandomState(3), 3, 32, with_dt=with_dt)
    t = synthetic_batch(np.random.RandomState(3), 3, 32, with_dt=with_dt)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        if k == "dts_barrier":
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_save_obj_matches_jax(rng, tmp_path):
    verts = rng.standard_normal((7, 3)).astype(np.float32)
    faces = rng.randint(0, 7, (5, 3))
    tex = rng.uniform(0, 1, (5, 9, 3)).astype(np.float32)
    save_obj(str(tmp_path / "t" / "m.obj"), verts, faces, tex)
    jax_save_obj(str(tmp_path / "j" / "m.obj"), verts, faces, tex)
    for name in ("m.obj", "m.mtl"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    # the atlas: the port writes it with its own codec (png.py), so the
    # files' bytes differ from imageio's; their pixels are equal
    np.testing.assert_array_equal(
        imageio.imread(tmp_path / "t" / "m.png"),
        imageio.imread(tmp_path / "j" / "m.png"))


@pytest.mark.parametrize("textures", ["vertex", None])
def test_save_obj_vertex_colours_match_jax(rng, tmp_path, textures):
    """texture_type='vertex' (avg_uv's vertex_label.obj) and no texture."""
    verts = rng.standard_normal((7, 3)).astype(np.float32)
    faces = rng.randint(0, 7, (5, 3))
    cols = rng.uniform(0, 1, (7, 3)) if textures else None
    save_obj(str(tmp_path / "t" / "m.obj"), verts, faces, cols,
             texture_type="vertex")
    jax_save_obj(str(tmp_path / "j" / "m.obj"), verts, faces, cols,
                 texture_type="vertex")
    assert ((tmp_path / "t" / "m.obj").read_bytes()
            == (tmp_path / "j" / "m.obj").read_bytes())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == ["m.obj"]


def test_color_map_and_colorize_match_jax(rng):
    for n, norm in ((5, True), (5, False), (256, False)):
        np.testing.assert_array_equal(image.color_map(n, norm),
                                      jimage.color_map(n, norm))
    gray = rng.randint(0, 6, (9, 13)).astype(np.uint8)
    gray[0, :3] = 255
    np.testing.assert_array_equal(image.colorize(gray, 5),
                                  jimage.colorize(gray, 5))


def test_identity_grid_matches_jax():
    from umr_tpu.ops.grid_sample import identity_grid as jgrid
    from umr_tpu_torch.ops.grid_sample import identity_grid

    for align in (True, False):
        np.testing.assert_allclose(identity_grid(5, 7, align).numpy(),
                                   np.asarray(jgrid(5, 7, align)),
                                   rtol=0, atol=2e-7)


@pytest.mark.parametrize("shape,scale", [((40, 30, 3), 256 / 40),
                                         ((300, 500, 3), 64 / 500)])
def test_demo_resize_and_crop_match_jax(rng, shape, scale):
    img = rng.uniform(0, 1, shape)
    ref, _ = jimage.resize_img(img, scale)
    out, _ = image.resize_img(img, scale)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    for bbox in ([-5, -3, 20, 40], [3, 2, 10, 12]):
        np.testing.assert_array_equal(image.crop(img, bbox, 1.0),
                                      jimage.crop(img, bbox, bgval=1.0))


def test_geometry_matches_jax(rng):
    from umr_tpu.utils import geometry as jgeo
    from umr_tpu_torch import geometry

    verts = rng.uniform(-1, 1, (9, 3))
    faces = rng.randint(0, 9, (12, 3))
    pts = rng.uniform(-1, 1, (7, 3))
    for direction in ((0.0, 0.0, 1.0), (0.3, -0.2, 0.9)):
        np.testing.assert_array_equal(
            geometry.project_points_on_mesh(pts, verts, faces, direction),
            jgeo.project_points_on_mesh(pts, verts, faces, direction))
    tri = verts[faces[0]]
    for o in pts:
        assert (geometry.ray_triangle_intersect(o, np.array([0, 0, 1.0]),
                                                *tri)
                == jgeo.ray_triangle_intersect(o, np.array([0, 0, 1.0]),
                                               *tri))


@pytest.mark.parametrize("kw", [{}, dict(n_iters=2, sxy=1.5, compat=3.0)])
def test_crf_matches_jax(rng, kw):
    from umr_tpu.utils.crf import denseCRF as jcrf
    from umr_tpu_torch.crf import denseCRF

    pred = rng.dirichlet(np.ones(4), size=(11, 13)).transpose(2, 0, 1)
    out = denseCRF(None, pred, **kw)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jcrf(None, pred, **kw))


def test_flow_and_distance_transforms_match_jax(rng):
    flow = rng.normal(0, 3, (9, 11, 2))
    flow[0, 0] = np.nan
    flow[1, 1] = 1e8
    for max_rad in (None, 2.5):
        got, r = image.flow_to_rgb(flow, max_rad)
        want, jr = jimage.flow_to_rgb(flow, max_rad)
        assert got.dtype == want.dtype and r == jr
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image._middlebury_wheel(),
                                  jimage._middlebury_wheel())
    mask = np.zeros((20, 14), np.float32)
    mask[4:15, 3:10] = 1
    np.testing.assert_array_equal(image.compute_dt(mask),
                                  jimage.compute_dt(mask))
    for k in (50, 10):
        np.testing.assert_array_equal(image.compute_dt_barrier(mask, k),
                                      jimage.compute_dt_barrier(mask, k))


def test_mesh_helpers_match_jax(rng):
    from umr_tpu.mesh.symmetry import symmetrize_np as jsym
    from umr_tpu.mesh.template import compute_edges2verts as je2v
    from umr_tpu_torch.mesh import compute_edges2verts, symmetrize_np

    t = build_template(2, 1, 2)
    got, want = (f(t.verts, t.faces) for f in (compute_edges2verts, je2v))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    half = rng.normal(size=(10, 3)).astype(np.float32)
    for axis in (0, 1):
        np.testing.assert_array_equal(symmetrize_np(half, 4, axis),
                                      jsym(half, 4, axis))


def test_load_obj_matches_jax(rng, tmp_path):
    from umr_tpu.utils.obj_io import load_obj as jload
    from umr_tpu_torch.obj_io import load_obj

    verts = rng.standard_normal((7, 3)).astype(np.float32)
    faces = rng.randint(0, 7, (5, 3))
    save_obj(str(tmp_path / "m.obj"), verts, faces,
             rng.uniform(0, 1, (5, 9, 3)).astype(np.float32))
    for norm in (False, True):
        got = load_obj(str(tmp_path / "m.obj"), normalization=norm)
        want = jload(str(tmp_path / "m.obj"), normalization=norm)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # save_obj writes 6 decimals
    np.testing.assert_allclose(load_obj(str(tmp_path / "m.obj"))[0], verts,
                               rtol=0, atol=5e-7)
    np.testing.assert_array_equal(load_obj(str(tmp_path / "m.obj"))[1],
                                  faces)
