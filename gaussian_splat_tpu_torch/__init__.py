"""gaussian_splat_tpu_torch — the PyTorch/CUDA port of gaussian_splat_tpu.

Same module layout and names as the JAX package beside it, so a reader finds
each counterpart; inside, PyTorch idiom: `nn.Module` parameters, plain
functions on tensors, explicit devices, and four hand-written CUDA kernels
(csrc/raster_fwd.cu, raster_bwd.cu, rank_perm.cu, segsum.cu) behind a
`torch.autograd.Function` where the JAX package has Pallas kernels.

Every module of the JAX package has its counterpart: the frame-serving path
— load/create a model, `render`, `Viewer.render_frame`, `cli render` — the
training path — `render`'s gradient, the photometric loss, per-group Adam,
`fit`, `fit_multiview`, `fit_multiview_adc` (density control at fixed N),
checkpoints, `cli train` — the interactive viewer — the native PLY reader
(native/gsply.cpp), transforms.json I/O, the grid/axes overlay, the drag
level-of-detail, the MJPEG `Viewer.serve()`, kernel hot reload, `cli view`
and `cli validate` — the utils (H100 roofline, numerics guards, profiler
trace), and multi-device rendering and training (`parallel/`: one process
per device over `torch.distributed`, `render_sharded`, the trainer's
`mesh=`).
The package imports torch and numpy only; it never imports jax or anything of
gaussian_splat_tpu.

Entry points run on the GPU unless the caller asks for the CPU: every public
constructor that creates tensors takes `device=None`, meaning "cuda", and
raises when no GPU is present rather than carrying on on the CPU.
"""

from gaussian_splat_tpu_torch.camera import Camera
from gaussian_splat_tpu_torch.config import RenderConfig, TrainConfig
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.render import calibrate_render_config, render
from gaussian_splat_tpu_torch.train.trainer import fit, fit_multiview, fit_multiview_adc

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "RenderConfig",
    "TrainConfig",
    "GaussianModel",
    "render",
    "calibrate_render_config",
    "fit",
    "fit_multiview",
    "fit_multiview_adc",
    "__version__",
]
