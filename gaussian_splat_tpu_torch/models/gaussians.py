"""GaussianModel — the trainable splat parameters as an `nn.Module`.

Counterpart of gaussian_splat_tpu/models/gaussians.py. Parameters are stored
RAW (log-scales, opacity logits, SH coefficients) and activated inside the
forward pass.

The level-of-detail and AABB filters (`lod`, `lod_pair_budget`,
`aabb_filter`) rank splats with the JAX package's own numpy code on float32
host copies of the leaves: `np.argsort(impact)[::-1]` is not a stable sort,
so only the same numpy code on the same float32 inputs keeps the same splats.
The rows they keep are then gathered on the model's device.

`GaussianModel.replace(...)` is the counterpart of the JAX model's `replace`:
it returns a `GaussianView`, the same five leaves as plain (possibly
non-leaf) tensors, which `render` takes like a model. The trainer uses it to
mask SH bands inside a step while gradients still reach the parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from gaussian_splat_tpu_torch._device import DeviceLike, resolve_device
from gaussian_splat_tpu_torch.ops import sh as sh_ops


LEAVES = ("means", "quats", "log_scales", "opacity_logits", "sh")


class _Splats:
    """What `render` reads of a scene: the five leaves and their activations."""

    LEAVES = LEAVES

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    @property
    def device(self) -> torch.device:
        return self.means.device

    # -- activations --------------------------------------------------------
    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    def replace(self, **leaves) -> "GaussianView":
        """The same scene with some leaves replaced by other tensors."""
        unknown = set(leaves) - set(LEAVES)
        if unknown:
            raise TypeError(f"not leaves of a GaussianModel: {sorted(unknown)}")
        return GaussianView(
            *(leaves.get(name, getattr(self, name)) for name in LEAVES)
        )


class GaussianView(_Splats):
    """Five leaves held as plain tensors (see `GaussianModel.replace`)."""

    def __init__(self, means, quats, log_scales, opacity_logits, sh):
        self.means = means
        self.quats = quats
        self.log_scales = log_scales
        self.opacity_logits = opacity_logits
        self.sh = sh


class GaussianModel(_Splats, nn.Module):
    """Five raw leaves, each an `nn.Parameter` leading with N:

      means (N,3) world positions; quats (N,4) wxyz (normalized in forward);
      log_scales (N,3), scale = exp; opacity_logits (N,), opacity = sigmoid;
      sh (N,K,3) SH coefficients, K = (degree+1)², band-ordered.
    """

    def __init__(self, means, quats, log_scales, opacity_logits, sh):
        super().__init__()
        self.means = nn.Parameter(means)
        self.quats = nn.Parameter(quats)
        self.log_scales = nn.Parameter(log_scales)
        self.opacity_logits = nn.Parameter(opacity_logits)
        self.sh = nn.Parameter(sh)

    # -- constructors -------------------------------------------------------
    @classmethod
    def create(
        cls, means, quats, log_scales, opacity_logits, sh,
        device: DeviceLike = None,
    ) -> "GaussianModel":
        device = resolve_device(device)

        def leaf(x):
            return torch.as_tensor(x, dtype=torch.float32).detach().to(device).clone()

        return cls(
            leaf(means), leaf(quats), leaf(log_scales), leaf(opacity_logits),
            leaf(sh),
        )

    @classmethod
    def random(
        cls,
        generator: torch.Generator,
        n: int,
        sh_degree: int = 0,
        extent: float = 1.0,
        scale_range=(0.01, 0.1),
        isotropic: bool = False,
        device: DeviceLike = None,
    ) -> "GaussianModel":
        """Random scene generator for tests and benchmarks. Same distributions
        as the JAX package's `GaussianModel.random`; the numbers differ, since
        the two frameworks' generators do. The generator must live on the
        device the scene is made on."""
        device = resolve_device(device)
        if generator.device.type != device.type:
            raise ValueError(
                f"generator is on {generator.device}, the scene on {device}: "
                f"make it with torch.Generator(device={device.type!r})"
            )

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, device=device)
            return lo + (hi - lo) * u

        def normal(shape):
            return torch.randn(shape, generator=generator, device=device)

        means = uniform((n, 3), -extent, extent)
        log_lo, log_hi = math.log(scale_range[0]), math.log(scale_range[1])
        if isotropic:
            quats = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1)
            log_scales = uniform((n, 1), log_lo, log_hi).repeat(1, 3)
        else:
            quats = normal((n, 4))
            quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
            log_scales = uniform((n, 3), log_lo, log_hi)
        opacity_logits = uniform((n,), -1.0, 3.0)
        K = sh_ops.num_sh_bases(sh_degree)
        sh = torch.zeros((n, K, 3), device=device)
        sh[:, 0, :] = sh_ops.rgb_to_sh_dc(uniform((n, 3), 0.1, 0.9))
        if K > 1:
            sh[:, 1:, :] = 0.1 * normal((n, K - 1, 3))
        return cls(means, quats, log_scales, opacity_logits, sh)

    # -- filters ------------------------------------------------------------
    def _host(self, name: str) -> np.ndarray:
        return getattr(self, name).detach().cpu().numpy()

    def lod(self, fraction: float) -> "GaussianModel":
        """Keep the `fraction` highest-impact splats (impact ≈ opacity ×
        max-scale², the view-independent part of expected screen coverage).

        Level-of-detail subset for interactive viewing: the viewer renders
        this while the camera is being dragged and the full model when idle.
        Ranked on the host, load/init time only."""
        n = self.num_gaussians
        k = max(1, min(n, int(n * fraction)))
        op = 1.0 / (1.0 + np.exp(-self._host("opacity_logits")))
        smax = np.exp(self._host("log_scales")).max(axis=-1)
        impact = op * smax * smax
        keep = np.argsort(impact)[::-1][:k]
        keep.sort()  # preserve original relative order
        return self._take_host(keep)

    def lod_pair_budget(
        self, cost_fraction: float, costs=None, values=None,
        order: str = "value",
    ) -> "GaussianModel":
        """Pair-budget LoD: keep the subset whose predicted tile-PAIR cost is
        ≤ `cost_fraction` of the full model's.

        Frame time scales with tile pairs, not with N, so splats are admitted
        in decreasing value order (or value-per-pair with `order="density"`)
        until `cost_fraction` of the total predicted cost is spent.

        `costs`: optional (N,) per-splat pair costs — the K-capped tile-rect
        areas of `ops.render.measure_pair_costs(model, camera, config)` at a
        representative pose; splats culled there (cost 0) are admitted last.
        Without it, a view-independent proxy `1 + β·smax²` is used.

        `values`: optional (N,) per-splat visual worth, e.g. the measured
        contribution of `ops.render.measure_splat_contributions`. Default:
        impact = opacity × world area, `lod()`'s ranking.

        `costs` and `values` may be numpy arrays or tensors. Ranked on the
        host, load/init time only. As in the JAX package, each culled splat
        is charged one pair in the budget's total."""
        n = self.num_gaussians
        op = 1.0 / (1.0 + np.exp(-self._host("opacity_logits")))
        smax = np.exp(self._host("log_scales")).max(axis=-1)
        area = smax * smax
        value = op * area if values is None else np.asarray(_numpy(values), np.float64)
        if costs is None:
            beta = n / max(float(area.sum()), 1e-12)
            cost = 1.0 + beta * area
        else:
            cost = np.asarray(_numpy(costs), np.float64)
            value = value * (cost > 0)  # splats culled at the pose sort last
            cost = np.maximum(cost, 1.0)
        key = value / cost if order == "density" else value
        idx = np.argsort(-key, kind="stable")
        csum = np.cumsum(cost[idx])
        k = int(np.searchsorted(csum, cost_fraction * csum[-1], side="right"))
        keep = idx[: max(1, min(n, k))]
        keep.sort()  # preserve original relative order
        return self._take_host(keep)

    def _take_host(self, keep) -> "GaussianModel":
        """The splats at host indices `keep`, in that order, gathered on the
        model's device into a new model."""
        idx = torch.tensor(np.array(keep, np.int64), device=self.device)
        return GaussianModel(
            *(getattr(self, name).detach()[idx] for name in LEAVES)
        )

    def aabb_filter(self, radius: float) -> "GaussianModel":
        """Keep splats with |x|,|y|,|z| < radius — the optional scene-load
        clip of the original viewer (radius 5 there). Load time only."""
        keep = np.all(np.abs(self._host("means")) < radius, axis=-1)
        return self._take_host(np.flatnonzero(keep))


def _numpy(x) -> np.ndarray:
    """A tensor's values on the host, or `x` as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
