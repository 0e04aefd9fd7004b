"""The projection kernels (csrc/projection.cu: proj_fwd, proj_bwd) on the
card, against their plain versions (ops/projection.py:
project_gaussians_torch with view_directions, and project_backward_torch)
run on the same card. Every test is marked `card` and skips without an
NVIDIA card. This file imports no JAX; on a machine with a card and without
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_projection_cuda.py

(tests/conftest.py sets JAX up for the CPU tests; --noconftest leaves it out.)
"""

import pytest
import torch

from gaussian_splat_tpu_torch import Camera, GaussianModel, RenderConfig, render
from gaussian_splat_tpu_torch.ops import cuda_raster
from gaussian_splat_tpu_torch.ops import projection as proj_ops
from gaussian_splat_tpu_torch.ops.binning import quantize_extent_up

pytestmark = pytest.mark.card

SIZES = (1_000, 1_000_000)
ALPHA_SKIP = 1.0 / 255.0
# gradients, per column: tolerance rtol·|want| + atol_rel·max|want of that
# column| (chip_smoke.py's rule), under cotangents of unit scale. The kernel
# and the plain float32 backward sum the same terms in another order, with
# fused multiply-adds; on ill-conditioned rows (flat splats, culled rows
# behind the camera) both stray from the exact gradient by as much, each by
# its own rounding. So both are held to the plain backward in float64: the
# kernel may be past the tolerance on no more elements than the plain
# float32 backward within that count's noise (SLACK times it, three standard
# deviations of a count, and 3), and by no more than twice as far.
GRAD_RTOL, GRAD_ATOL_REL = 3e-3, 5e-6
SLACK = 1.05
FIELDS = ("means2d", "conics", "depths", "radii", "valid", "cov2d", "compensation", "extents")
COTANGENTS = ("means2d", "conics", "depths", "cov2d", "compensation", "extents", "dirs")
# the cotangents a train step gives: the raster stage's and SH colour's
TRAIN_COTANGENTS = ("means2d", "conics", "depths", "dirs")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _camera(dev):
    return Camera.from_lookat((0.3, 0.5, -5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0,
                              1152, 864, device=dev)


def _inputs(n, seed, dev):
    """n splats around the origin: some behind the camera, some past the
    frustum's 1.3× clamp, some nearly flat (degenerate 2D covariances), a
    zero quaternion, and opacities on both sides of α_skip."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    means = 2.5 * torch.randn((n, 3), generator=gen, device=dev)
    means[: n // 10, 2] -= 8.0  # behind the camera
    quats = torch.randn((n, 4), generator=gen, device=dev)
    quats[n // 2] = 0.0
    log_scales = torch.empty((n, 3), device=dev).uniform_(-6.0, -1.0, generator=gen)
    log_scales[: n // 7, 0] = -12.0  # nearly flat
    opacities = torch.rand((n,), generator=gen, device=dev)
    return means, quats, torch.exp(log_scales), opacities


def _kwargs(aware, opacities):
    return dict(opacities=opacities, alpha_skip=ALPHA_SKIP) if aware else {}


def _cotangents(names, n, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    widths = dict(means2d=2, conics=3, depths=0, cov2d=3, compensation=0, extents=2, dirs=3)
    return proj_ops.ProjectionGrads(**{
        name: torch.randn((n, widths[name]) if widths[name] else (n,), generator=gen,
                          device=dev)
        for name in names
    })


def _grad_close(got, plain, truth):
    """The kernel's gradient `got` and the plain float32 backward's `plain`
    against `truth`, the plain backward in float64 (see GRAD_RTOL): NaN where
    the plain float32 backward gives NaN, and on the rows where none of the
    three is NaN, as close to `truth` as the plain float32 backward."""
    if got is None or plain is None:
        return got is None and plain is None and truth is None
    nan = torch.isnan(plain)  # a square root's gradient at 0 / 0
    if not torch.equal(nan, torch.isnan(got)):
        return False
    nan = nan | torch.isnan(truth)
    keep = ~nan if truth.dim() == 1 else ~nan.any(-1)
    got, plain, truth = got[keep].double(), plain[keep].double(), truth[keep]
    if not truth.numel():
        return True
    scale = truth.reshape(-1, truth.shape[-1] if truth.dim() > 1 else 1).abs().amax(dim=0)
    tol = GRAD_RTOL * truth.abs() + GRAD_ATOL_REL * scale
    ratio, plain_ratio = (got - truth).abs() / tol, (plain - truth).abs() / tol
    plain_over = int((plain_ratio > 1).sum())
    return int((ratio > 1).sum()) <= SLACK * plain_over + 3 * plain_over ** 0.5 + 3 and \
        float(ratio.max()) <= 2 * float(plain_ratio.max()) + 1


def test_sums_keep_the_order_of_torchs_reduction(dev):
    """proj_fwd sums a quaternion's four squares as (q0² + q2²) + (q1² + q3²)
    and a direction's three as (d0² + d2²) + d1²: the order of torch.sum over
    a last dimension of 4 and of 3 on this card."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((1_000_003, 4), generator=gen, device=dev)
    sq = q * q
    assert torch.equal(torch.sum(sq, dim=-1, keepdim=True)[:, 0],
                       (sq[:, 0] + sq[:, 2]) + (sq[:, 1] + sq[:, 3]))
    d = sq[:, :3].contiguous()
    assert torch.equal(torch.sum(d, dim=-1, keepdim=True)[:, 0], (d[:, 0] + d[:, 2]) + d[:, 1])


@pytest.mark.parametrize("aware", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_forward_is_bitwise_the_plain_forward(dev, n, aware):
    means, quats, scales, opacities = _inputs(n, 10 + n, dev)
    cam = _camera(dev)
    kw = _kwargs(aware, opacities)
    got, dirs = proj_ops.project_with_directions(means, quats, scales, cam, **kw)
    want = proj_ops.project_gaussians_torch(means, quats, scales, cam, **kw)
    want_dirs = proj_ops.view_directions(means, cam)
    torch.cuda.synchronize()
    assert 0 < int(want.valid.sum()) < n
    # what binning reads first, then every float field bit for bit
    assert torch.equal(got.radii, want.radii) and torch.equal(got.valid, want.valid)
    assert torch.equal(quantize_extent_up(got.extents), quantize_extent_up(want.extents))
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(dirs, want_dirs)


@pytest.mark.parametrize("names", [TRAIN_COTANGENTS, COTANGENTS], ids=["train", "every"])
@pytest.mark.parametrize("aware", [False, True])
def test_backward_matches_the_plain_backward(dev, aware, names):
    """Every float output's cotangent (the antialiased compensation and the
    extents included) or the train step's set, at 1M rows; where the plain
    backward gives NaN (a square root's gradient at 0), so does the kernel."""
    n = SIZES[-1]
    means, quats, scales, opacities = _inputs(n, 20 + aware, dev)
    cam = _camera(dev)
    kw = _kwargs(aware, opacities)
    grads = _cotangents(names, n, 30, dev)
    settings = proj_ops._Settings(0.01, 0.3, 3.0, ALPHA_SKIP if aware else None)
    got = proj_ops.projection_backward(means, quats, scales, opacities if aware else None,
                                       cam, settings, grads)
    plain = proj_ops.project_backward_torch(means, quats, scales, cam, grads, **kw)
    truth = proj_ops.project_backward_torch(
        means.double(), quats.double(), scales.double(), cam,
        proj_ops.ProjectionGrads(*(None if g is None else g.double() for g in grads)),
        **_kwargs(aware, opacities.double()))
    torch.cuda.synchronize()
    for name, g, p, t in zip(("means", "quats", "scales", "opacities"), got, plain, truth):
        assert _grad_close(g, p, t), name
    assert torch.nan_to_num(got[0]).abs().max() > 0


def test_launches_once_a_render_and_once_a_backward(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    model = GaussianModel.random(gen, 500, sh_degree=3, extent=1.0,
                                 scale_range=(0.02, 0.08), device=dev)
    cam = Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 96, 64, device=dev)
    cuda_raster.reset_launch_counts()
    with torch.no_grad():
        render(model, cam, RenderConfig())
    assert cuda_raster.launch_counts["proj_fwd"] == 1
    assert cuda_raster.launch_counts["proj_bwd"] == 0
    cuda_raster.reset_launch_counts()
    render(model, cam, RenderConfig()).image.sum().backward()
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 1)
    assert all(bool(torch.isfinite(getattr(model, k).grad).all()) for k in model.LEAVES)
    assert model.quats.grad.abs().max() > 0 and model.log_scales.grad.abs().max() > 0


def test_refuses_what_the_kernels_do_not_take(dev):
    """float64, non-contiguous or misshapen inputs and a camera on another
    device raise, through the differentiable stage too: nothing falls back
    to the plain version."""
    means, quats, scales, opacities = _inputs(300, 5, dev)
    cam = _camera(dev)
    strided = torch.empty((300, 8), device=dev)[:, ::2]
    cuda_raster.reset_launch_counts()
    for bad, err in ((quats.double(), TypeError), (strided, ValueError),
                     (quats[:, :3].contiguous(), ValueError)):
        with pytest.raises(err):
            proj_ops.project_with_directions(means, bad, scales, cam)
    with pytest.raises(TypeError):
        proj_ops.project_gaussians(means, quats, scales, cam, opacities=opacities.double(),
                                   alpha_skip=ALPHA_SKIP)
    with pytest.raises(ValueError):
        proj_ops.project_gaussians(means, quats, scales, cam.to("cpu"))
    assert cuda_raster.launch_counts == dict.fromkeys(cuda_raster.KERNELS, 0)


def test_two_runs_are_bitwise_equal(dev):
    n = SIZES[-1]
    means, quats, scales, opacities = _inputs(n, 7, dev)
    cam = _camera(dev)
    settings = proj_ops._Settings(0.01, 0.3, 3.0, ALPHA_SKIP)
    grads = _cotangents(COTANGENTS, n, 8, dev)

    def run():
        proj, dirs = proj_ops.projection_forward(means, quats, scales, opacities, cam, settings)
        back = proj_ops.projection_backward(means, quats, scales, opacities, cam, settings, grads)
        return (*proj, dirs, *back)

    def bits(t):  # NaNs compare equal by their bits
        return t.view(torch.int32) if t.is_floating_point() else t

    first, again = run(), run()
    assert all(torch.equal(bits(a), bits(b)) for a, b in zip(first, again))
    assert bool(first[-4].isfinite().any())
