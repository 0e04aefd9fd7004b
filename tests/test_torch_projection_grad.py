"""The projection's explicit backward (`project_backward_torch`, the formulas
the proj_bwd kernel computes) against autograd through the plain forward
(`project_gaussians_torch` and `view_directions`), in float64 and float32,
and against `jax.vjp` of the JAX package's `project_gaussians` and
`view_directions`; the differentiable stage on CPU tensors; and render's
gradients, `screen_offset` and the antialiased mode included.

The scenes hold every case the backward has a rule for: splats behind the
near plane, splats past the 1.3× frustum clamp, needles whose 2D covariance
is singular (det ≤ 0 before the dilation, so the compensation's square root
sits at 0), opacities below α_skip (a zero extent), a zero quaternion.
Where autograd gives NaN (a square root's gradient at 0 / 0), the explicit
backward gives NaN in the same places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu.ops import projection as jax_proj
from gaussian_splat_tpu_torch import Camera, GaussianModel, RenderConfig, convert, render
from gaussian_splat_tpu_torch.ops import cuda_raster
from gaussian_splat_tpu_torch.ops import projection as proj
from gaussian_splat_tpu_torch.ops import render as render_ops

ALPHA_SKIP = 1.0 / 255.0
COTANGENTS = proj.ProjectionGrads._fields
LEAVES = ("means", "quats", "scales", "opacities")
# the north star's gradient tolerances, per column: |got − want| ≤
# rtol·|want| + atol·max|want of the column|
NORTH_RTOL, NORTH_ATOL = 3e-3, 5e-6
# the same float32 arithmetic as autograd's, summed in another order
F32_RTOL, F32_ATOL = 1e-4, 1e-6
F64_REL = 1e-10


def _scene(seed, n=240, width=128, height=96):
    """numpy leaves (activated scales and opacities) and the JAX and port
    cameras of one pose."""
    leaves = convert.random_leaves(seed, n, extent=1.5, scale_range=(0.02, 0.3))
    means = leaves["means"].astype(np.float64)
    means[: n // 10, 2] -= 6.0  # behind the camera
    means[n // 10: n // 5, 0] *= 4.0  # past the frustum's 1.3× clamp
    quats = leaves["quats"].astype(np.float64)
    quats[-1] = 0.0
    scales = np.exp(leaves["log_scales"]).astype(np.float64)
    scales[n // 5: n // 4, 1:] = 1e-6  # needles: a singular 2D covariance
    op = 1.0 / (1.0 + np.exp(-leaves["opacity_logits"].astype(np.float64)))
    op[:5] = 0.002  # below α_skip: a zero extent when opacity-aware
    jc = JaxCamera.from_lookat((0, 0.3, -4), (0, 0, 0), (0, 1, 0), 60.0, width, height)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), np.asarray(jc.fx), np.asarray(jc.fy),
        np.asarray(jc.cx), np.asarray(jc.cy), width, height, device="cpu",
    )
    return (means, quats, scales, op), jc, tc


def _cotangents(n, seed, dtype, names=COTANGENTS):
    rng = np.random.default_rng(seed)
    widths = dict(means2d=2, conics=3, depths=0, cov2d=3, compensation=0, extents=2, dirs=3)
    return proj.ProjectionGrads(**{
        k: torch.from_numpy(rng.standard_normal((n, widths[k]) if widths[k] else (n,))).to(dtype)
        for k in names
    })


def _kwargs(aware, op):
    return dict(opacities=op, alpha_skip=ALPHA_SKIP) if aware else {}


def _autograd(arrays, cam, aware, grads, dtype):
    """Autograd through the plain forward: the gradient of each leaf, None
    where no given cotangent reaches it."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    means, quats, scales, op = leaves
    p = proj.project_gaussians_torch(means, quats, scales, cam, **_kwargs(aware, op))
    outs = dict(p._asdict(), dirs=proj.view_directions(means, cam))
    pairs = [(outs[k], g) for k, g in grads._asdict().items() if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                               allow_unused=True)


def _explicit(arrays, cam, aware, grads, dtype):
    means, quats, scales, op = (torch.from_numpy(a).to(dtype) for a in arrays)
    return proj.project_backward_torch(means, quats, scales, cam, grads, **_kwargs(aware, op))


def _assert_close(got, want, rtol, atol, name):
    """NaN in the same places; elsewhere within rtol·|want| + atol·(column max)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    ok = ~np.isnan(want)
    cols = want.reshape(want.shape[0], -1)
    scale = np.where(np.isnan(cols), 0.0, np.abs(cols)).max(axis=0).reshape(want.shape[1:])
    np.testing.assert_allclose(got[ok], want[ok],
                               atol=float(atol * np.max(scale)), rtol=rtol, err_msg=name)


def _compare(got, want, rtol, atol, aware):
    for name, g, w in zip(LEAVES, got, want):
        if name == "opacities" and not aware:
            assert g is None
            continue
        assert (g is None) == (w is None), name
        if w is not None:
            _assert_close(g.detach().numpy(), w.detach().numpy(), rtol, atol, name)


def test_scene_holds_every_case():
    arrays, _, cam = _scene(0)
    t = proj._terms(*(torch.from_numpy(a).float() for a in arrays[:3]), cam, 0.01, 0.3, 3.0,
                    torch.from_numpy(arrays[3]).float(), ALPHA_SKIP)
    assert (~t.in_front).sum() > 0 and (t.in_front & (t.ux.abs() > t.lim_x)).sum() > 0
    assert (t.det_raw <= 0).sum() > 0 and (t.sigma_pos == 0).sum() > 0
    assert 0 < int(t.valid.sum()) < len(t.valid)


@pytest.mark.parametrize("aware", [False, True])
def test_backward_matches_autograd_in_float64(aware):
    arrays, _, cam = _scene(1)
    grads = _cotangents(len(arrays[0]), 2, torch.float64)
    want = _autograd(arrays, cam, aware, grads, torch.float64)
    got = _explicit(arrays, cam, aware, grads, torch.float64)
    assert any(np.isnan(g.numpy()).any() for g in got if g is not None)  # 0 / 0 rows
    _compare(got, want, 0.0, F64_REL, aware)


@pytest.mark.parametrize("aware", [False, True])
def test_backward_matches_autograd_in_float32(aware):
    arrays, _, cam = _scene(3)
    grads = _cotangents(len(arrays[0]), 4, torch.float32)
    _compare(_explicit(arrays, cam, aware, grads, torch.float32),
             _autograd(arrays, cam, aware, grads, torch.float32), F32_RTOL, F32_ATOL, aware)


@pytest.mark.parametrize("names", [("means2d", "depths"), ("dirs",),
                                   ("means2d", "conics", "depths", "dirs")],
                         ids=["screen", "dirs", "train"])
def test_cotangents_left_out_walk_no_branch(names):
    """Outputs that take no gradient: their branches are not walked, so the
    square roots at 0 of the compensation and the extents give no NaN, and a
    leaf that no given cotangent reaches gets None, as from autograd."""
    arrays, _, cam = _scene(5)
    grads = _cotangents(len(arrays[0]), 6, torch.float64, names)
    got = _explicit(arrays, cam, True, grads, torch.float64)
    want = _autograd(arrays, cam, True, grads, torch.float64)
    _compare(got, want, 0.0, F64_REL, True)
    assert not np.isnan(got[0].numpy()[:-1]).any()  # only the zero quaternion's row
    assert (got[1] is None) == ("conics" not in names)


@pytest.mark.parametrize("aware", [False, True])
def test_backward_matches_jax_vjp(aware):
    """float32 against jax.vjp of the JAX stage, on rows where the two agree
    on every cull, both are finite, and det_raw = a·c − b² keeps a thousandth
    of a·c (the needles' det_raw is rounding noise, and so is the
    compensation's gradient there, in either float32 stage)."""
    arrays, jc, cam = _scene(7)
    n = len(arrays[0])
    grads = _cotangents(n, 8, torch.float32)
    f32 = [a.astype(np.float32) for a in arrays]

    def stage(means, quats, scales, op):
        p = jax_proj.project_gaussians(means, quats, scales, jc,
                                       **(dict(opacities=op, alpha_skip=ALPHA_SKIP) if aware else {}))
        return (p.means2d, p.conics, p.depths, p.cov2d, p.compensation, p.extents,
                jax_proj.view_directions(means, jc)), (p.valid, p.radii)

    outs, vjp, (j_valid, j_radii) = jax.vjp(stage, *map(jnp.asarray, f32), has_aux=True)
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(g.numpy()) for g in grads))]
    got = _explicit(arrays, cam, aware, grads, torch.float32)
    t = proj._terms(*(torch.from_numpy(a) for a in f32[:3]), cam, 0.01, 0.3, 3.0,
                    torch.from_numpy(f32[3]) if aware else None, ALPHA_SKIP if aware else None)
    radii = torch.where(t.valid, t.radii, 0).numpy()
    same = (np.asarray(j_valid) == t.valid.numpy()) & (np.asarray(j_radii) == radii)
    same &= (t.det_raw.abs() > 1e-3 * (t.a0 * t.c0).abs()).numpy()
    for name, g, w in zip(LEAVES, got, want):
        if name == "opacities" and not aware:
            continue
        g = g.numpy()
        rows = same & np.isfinite(g.reshape(n, -1)).all(-1) & np.isfinite(w.reshape(n, -1)).all(-1)
        assert rows.sum() > 0.9 * n, name
        _assert_close(g[rows], w[rows], NORTH_RTOL, NORTH_ATOL, name)


def test_frustum_clamp_ties_split_the_gradient():
    """A point exactly on the 1.3× frustum bound, on either side: autograd's
    minimum and maximum split the gradient evenly there, and so does the
    explicit backward."""
    cam = Camera(viewmat=torch.eye(4), fx=torch.tensor(100.0), fy=torch.tensor(80.0),
                 cx=torch.tensor(100.0), cy=torch.tensor(60.0), width=200, height=120)
    lim_x = float(1.3 * (0.5 * cam.width / cam.fx))
    lim_y = float(1.3 * (0.5 * cam.height / cam.fy))
    means = np.array([[lim_x, 0.1, 1.0], [-lim_x, -lim_y, 1.0], [0.2, lim_y, 1.0]])
    quats = np.array([[0.9, 0.1, 0.3, -0.2]] * 3)
    scales = np.tile([0.3, 0.1, 0.2], (3, 1))
    arrays = (means, quats, scales, np.full(3, 0.8))
    t = proj._terms(*(torch.from_numpy(a) for a in arrays[:3]), cam, 0.01, 0.3, 3.0, None, None)
    assert bool((t.ux == t.lim_x)[0]) and bool((t.ux == -t.lim_x)[1])
    assert bool((t.uy == -t.lim_y)[1]) and bool((t.uy == t.lim_y)[2])
    grads = _cotangents(3, 9, torch.float64)
    _compare(_explicit(arrays, cam, False, grads, torch.float64),
             _autograd(arrays, cam, False, grads, torch.float64), 0.0, F64_REL, False)


def test_stage_on_cpu_runs_the_plain_backward():
    """On CPU tensors `project_with_directions` is the stage CUDA tensors
    take: its gradient is project_backward_torch's exactly, no kernel is
    launched, outputs that no input requiring a gradient reaches take none,
    and a camera that requires a gradient is refused."""
    arrays, _, cam = _scene(11)
    leaves = [torch.from_numpy(a).float().requires_grad_() for a in arrays]
    grads = _cotangents(len(arrays[0]), 12, torch.float32)
    cuda_raster.reset_launch_counts()
    p, dirs = proj.project_with_directions(*leaves[:3], cam, opacities=leaves[3],
                                           alpha_skip=ALPHA_SKIP)
    outs = [*(getattr(p, k) for k in COTANGENTS[:-1]), dirs]
    got = torch.autograd.grad(outs, leaves, list(grads))
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 0)
    want = _explicit(arrays, cam, True, grads, torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert not p.radii.requires_grad and not p.valid.requires_grad

    only_op = [leaf.detach() for leaf in leaves[:3]]
    p, dirs = proj.project_with_directions(*only_op, cam, opacities=leaves[3],
                                           alpha_skip=ALPHA_SKIP)
    assert p.extents.requires_grad
    assert not any(t.requires_grad for t in (p.means2d, p.conics, p.depths, p.cov2d,
                                              p.compensation, dirs))
    posed = Camera(cam.viewmat.clone().requires_grad_(), cam.fx, cam.fy, cam.cx, cam.cy,
                   cam.width, cam.height)
    with pytest.raises(ValueError):
        proj.project_with_directions(*leaves[:3], posed)


@pytest.mark.parametrize("antialiased", [False, True])
def test_render_gradients_match_autograd(monkeypatch, antialiased):
    """render(backend="torch_tile") on CPU tensors with a `screen_offset`
    (densify's criterion): the five leaves' and the offset's gradients
    through the explicit backward equal those of autograd through the plain
    projection; the antialiased mode gives the compensation a cotangent."""
    rng = np.random.RandomState(4)
    n = 48
    model = GaussianModel.create(
        means=0.8 * rng.randn(n, 3), quats=rng.randn(n, 4),
        log_scales=np.log(rng.uniform(0.05, 0.25, (n, 3))),
        opacity_logits=rng.uniform(-1.0, 2.0, n), sh=0.5 * rng.randn(n, 16, 3), device="cpu",
    )
    cam = Camera.from_lookat((0.2, 0, -3), (0, 0, 0), (0, 1, 0), 60.0, 48, 32, device="cpu")
    cfg = RenderConfig(backend="torch_tile", antialiased=antialiased)
    weights = torch.from_numpy(rng.randn(32, 48, 3).astype(np.float32))

    def grads(m):
        offset = torch.zeros((n, 2), requires_grad=True)
        (render(m, cam, cfg, screen_offset=offset).image * weights).sum().backward()
        return {**{k: getattr(m, k).grad.clone() for k in m.LEAVES}, "offset": offset.grad}

    got = grads(model)

    def plain(means, quats, scales, camera, **kw):
        return proj.project_gaussians_torch(means, quats, scales, camera, **kw), \
            proj.view_directions(means, camera)

    fresh = model.replace(**{k: getattr(model, k).detach().clone().requires_grad_()
                             for k in GaussianModel.LEAVES})
    monkeypatch.setattr(render_ops, "project_with_directions", plain)
    want = grads(fresh)
    assert got["offset"].abs().max() > 0 and got["quats"].abs().max() > 0
    for k in got:
        _assert_close(got[k].numpy(), want[k].numpy(), F32_RTOL, F32_ATOL, k)
