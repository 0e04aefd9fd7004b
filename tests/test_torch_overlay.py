"""The port's grid/axes overlay against the JAX package's, and the checks of
tests/test_overlay.py on the port."""

import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.viewer import overlay as jov
from gaussian_splat_tpu_torch import convert
from gaussian_splat_tpu_torch.viewer import overlay as tov

ATOL = 1e-5


def _cams(w=96, h=72, eye=(0, 2, -5)):
    jc = JaxCamera.from_lookat(eye, (0, 0, 0), (0, 1, 0), 50.0, w, h)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, w, h, device="cpu"
    )
    return jc, tc


def _scene(mod, rng):
    """Every kind of renderable, from the same numbers: a grid (44 segments,
    not a multiple of the port's chunk), axes, a mesh, points, and an object
    with a model matrix."""
    tris = rng.uniform(-1.0, 1.0, (3, 3, 3))
    pts = rng.uniform(-1.5, 1.5, (11, 3))
    cols = rng.uniform(0.0, 1.0, (11, 3))
    moved = mod.axes(1.0)
    moved.model_matrix = np.asarray(
        [[0, -1, 0, 0.5], [1, 0, 0, 0.2], [0, 0, 1, -0.3], [0, 0, 0, 1]], np.float32
    )
    return [mod.grid(10, 1.0), mod.axes(2.0), mod.triangle_mesh(tris, [0.5, 0.6, 0.7]),
            mod.point_cloud(pts, cols), moved]


@pytest.mark.parametrize("eye,size", [((0, 2, -5), (96, 72)), ((3, 0.5, 2), (61, 47)),
                                      ((0, 8, -0.5), (40, 40))])
def test_render_overlay_matches_jax(eye, size):
    jc, tc = _cams(*size, eye=eye)
    want_rgb, want_cov = jov.render_overlay(_scene(jov, np.random.default_rng(0)), jc)
    got_rgb, got_cov = tov.render_overlay(_scene(tov, np.random.default_rng(0)), tc)
    np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_cov.numpy(), np.asarray(want_cov), rtol=0, atol=ATOL)
    assert 0.0 < float(got_cov.mean()) < 0.9


def test_line_width_and_point_radius_match_jax():
    jc, tc = _cams()
    pts = np.random.default_rng(2).uniform(-1, 1, (20, 3))
    kw = dict(line_width=2.5, point_radius=3.5)
    want = jov.render_overlay([jov.grid(4, 0.5), jov.point_cloud(pts, pts * 0 + 0.5)], jc, **kw)
    got = tov.render_overlay([tov.grid(4, 0.5), tov.point_cloud(pts, pts * 0 + 0.5)], tc, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_composite_over_background_matches_jax():
    jc, tc = _cams(48, 40)
    rng = np.random.default_rng(3)
    splat = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    t_final = rng.uniform(0, 1, (40, 48)).astype(np.float32)
    ov_rgb, ov_cov = tov.render_overlay([tov.axes(1.0), tov.grid(6, 0.8)], tc)
    bg = (0.2, 0.05, 0.3)
    got = tov.composite_over_background(
        torch.from_numpy(splat), torch.from_numpy(t_final), ov_rgb, ov_cov, bg
    )
    want = jov.composite_over_background(splat, t_final, ov_rgb.numpy(), ov_cov.numpy(), bg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_structure_of_the_objects():
    g, a = tov.grid(10, 1.0), tov.axes(2.0)
    assert g.vertices.shape == (44, 3) and g.kind == "lines"
    np.testing.assert_array_equal(g.vertices, jov.grid(10, 1.0).vertices)
    np.testing.assert_array_equal(a.colors, jov.axes(2.0).colors)
    tm = tov.triangle_mesh([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], [0.5, 0.5, 0.5])
    assert tm.vertices.shape == (6, 3)


def test_points_and_mesh():
    _, tc = _cams()
    pc = tov.point_cloud([[0, 0, 0], [0.5, 0.2, 0]], [[1, 0, 0], [0, 1, 0]])
    tm = tov.triangle_mesh([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], [0.5, 0.5, 0.5])
    _, cov = tov.render_overlay([pc, tm], tc)
    assert float(cov.max()) > 0.5


def test_behind_camera_culled():
    _, tc = _cams()
    _, cov = tov.render_overlay([tov.point_cloud([[0, 0, -100]], [[1, 1, 1]])], tc)
    assert float(cov.max()) < 1e-6
    # a segment with one end behind the camera is dropped whole, as in JAX
    seg = tov.Renderable(np.asarray([[0, 0, 0], [0, 0, -100]], np.float32),
                         np.ones((2, 3), np.float32))
    _, cov = tov.render_overlay([seg], tc)
    assert float(cov.max()) < 1e-6


def test_splats_over_overlay_order():
    _, tc = _cams(32, 32)
    rgb, cov = tov.render_overlay([tov.axes(1.0)], tc)
    splat = torch.full((32, 32, 3), 0.7)
    out = tov.composite_over_background(splat, torch.zeros(32, 32), rgb, cov)
    torch.testing.assert_close(out, splat, rtol=0, atol=1e-6)
    out2 = tov.composite_over_background(
        torch.zeros_like(splat), torch.ones(32, 32), rgb, cov, (0.1, 0.1, 0.15)
    )
    np.testing.assert_allclose(out2[0, 0].numpy(), [0.1, 0.1, 0.15], atol=1e-5)
