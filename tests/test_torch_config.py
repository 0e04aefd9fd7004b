"""Port RenderConfig and TrainConfig vs the JAX ones: shared defaults and capacities."""

import dataclasses

import pytest

from gaussian_splat_tpu.config import RenderConfig as JaxConfig
from gaussian_splat_tpu.config import TrainConfig as JaxTrainConfig
from gaussian_splat_tpu_torch.config import RenderConfig as TorchConfig
from gaussian_splat_tpu_torch.config import TrainConfig as TorchTrainConfig

TPU_ONLY = {"tiles_per_program", "dma_chunks", "exact_vjp"}


def test_port_keeps_every_semantic_field():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    torch_fields = {f.name for f in dataclasses.fields(TorchConfig)}
    assert jax_fields - torch_fields == TPU_ONLY
    assert torch_fields <= jax_fields


@pytest.mark.parametrize(
    "name", [f.name for f in dataclasses.fields(TorchConfig) if f.name != "backend"]
)
def test_shared_default_equal(name):
    assert getattr(TorchConfig(), name) == getattr(JaxConfig(), name)


def test_backend_names():
    assert TorchConfig().backend == JaxConfig().backend == "auto"
    assert TorchConfig().sigma_cutoff == JaxConfig().sigma_cutoff
    assert TorchConfig().tile_pixels == JaxConfig().tile_pixels


@pytest.mark.parametrize("kwargs", [
    {},
    {"pairs_per_gaussian": 0.7},
    {"big_tier_capacity": 3},
    {"big_tier_capacity": 5000, "pairs_per_gaussian": 2.46},
    {"tile_width": 16, "chunk_size": 64, "small_tiles_per_gaussian": 4},
])
def test_capacities_equal_on_grid(kwargs):
    jc, tc = JaxConfig(**kwargs), TorchConfig(**kwargs)
    for n in (1, 7, 120, 2000, 4097, 100_000, 1_000_000):
        assert tc.pair_budget(n) == jc.pair_budget(n)
        assert tc.big_capacity(n) == jc.big_capacity(n)
    for w, h in ((96, 64), (128, 96), (1920, 1080), (3840, 2160), (33, 17)):
        assert tc.num_tiles(w, h) == jc.num_tiles(w, h)
        assert tc.tiles_x(w) == jc.tiles_x(w)
        assert tc.tiles_y(h) == jc.tiles_y(h)


def test_train_config_has_the_same_fields_in_the_same_order():
    assert [f.name for f in dataclasses.fields(TorchTrainConfig)] == [
        f.name for f in dataclasses.fields(JaxTrainConfig)
    ]


@pytest.mark.parametrize("name", [f.name for f in dataclasses.fields(TorchTrainConfig)])
def test_train_config_default_equal(name):
    assert getattr(TorchTrainConfig(), name) == getattr(JaxTrainConfig(), name)
