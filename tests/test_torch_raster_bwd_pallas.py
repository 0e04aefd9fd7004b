"""The raster stage's explicit backward (the plain versions of raster_bwd and
segsum behind `cuda_raster.rasterize`) against the TPU kernels themselves:
JAX `render_tiled_pallas` in interpret mode with `exact_vjp=True`. Scenes,
loss and tolerance are those of tests/test_torch_raster_bwd.py."""

import pytest

from test_torch_raster_bwd import (
    CASES, IDS, _assert_grads_close, _jax_grads, _torch_grads,
)


@pytest.mark.parametrize(
    "case", [CASES[0], CASES[1], CASES[3], CASES[4]],
    ids=[IDS[0], IDS[1], IDS[3], IDS[4]],
)
def test_explicit_backward_matches_pallas_exact_vjp(case):
    """Against the TPU kernels themselves (interpret mode). With sat_check the
    Pallas kernels skip saturated chunks, the plain versions walk everything:
    the gradients then differ by O(transmittance_eps), inside the tolerance."""
    kind, seed, width, height, kw = case
    _assert_grads_close(
        _torch_grads(True, kind, seed, width, height, **kw),
        _jax_grads("pallas", kind, seed, width, height, **kw), "pallas",
    )
