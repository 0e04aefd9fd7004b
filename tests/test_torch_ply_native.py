"""The port's native PLY (de)interleaver (native/gsply.cpp, built with g++)
against its numpy path and against the JAX package's reader and writer."""

import numpy as np
import pytest

from gaussian_splat_tpu.io import ply as jax_ply
from gaussian_splat_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splat_tpu_torch import convert, native
from gaussian_splat_tpu_torch.io import ply as torch_ply


def _read_both(path):
    got_native = torch_ply.read_ply(str(path))
    native_path = torch_ply.last_read_path
    got_numpy = torch_ply.read_ply(str(path), use_native=False)
    assert torch_ply.last_read_path == "numpy"
    return got_native, native_path, got_numpy


def _assert_bitwise(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == np.float32 and b[k].dtype == np.float32, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("sh_degree,n", [(0, 3), (1, 70_001), (2, 33), (3, 257)])
def test_native_read_equals_numpy_and_jax(tmp_path, sh_degree, n):
    """70,001 rows: above the size at which gsply.cpp splits rows over threads."""
    leaves = convert.random_leaves(10 + sh_degree, n, sh_degree=sh_degree)
    path = tmp_path / "scene.ply"
    jax_ply.save_gaussians(str(path), JaxModel.create(**leaves))
    got_native, native_path, got_numpy = _read_both(path)
    assert native_path == "native"
    _assert_bitwise(got_native, got_numpy)
    _assert_bitwise(got_native, jax_ply.read_ply(str(path), use_native=False))


def test_native_read_of_mixed_dtypes(tmp_path):
    """uchar colours beside double, short and int properties: every dtype
    the deinterleaver converts, row stride not a multiple of 4."""
    rng = np.random.default_rng(5)
    n = 1000
    dt = np.dtype([("x", "<f4"), ("y", "<f8"), ("z", "<f4"), ("red", "u1"),
                   ("green", "u1"), ("blue", "u1"), ("s", "<i2"), ("i", "<i4"),
                   ("u", "<u2"), ("c", "i1"), ("w", "<u4")])
    data = np.zeros(n, dt)
    data["x"] = rng.standard_normal(n)
    data["y"] = rng.standard_normal(n) * 1e3  # rounds when taken to float32
    data["z"] = rng.standard_normal(n)
    for name in ("red", "green", "blue"):
        data[name] = rng.integers(0, 256, n)
    data["s"] = rng.integers(-30000, 30000, n)
    data["i"] = rng.integers(-2**31, 2**31 - 1, n)  # not exact in float32
    data["u"] = rng.integers(0, 65535, n)
    data["c"] = rng.integers(-128, 127, n)
    data["w"] = rng.integers(0, 2**32 - 1, n, dtype=np.uint64)
    types = {"<f4": "float", "<f8": "double", "u1": "uchar", "<i2": "short",
             "<i4": "int", "<u2": "ushort", "i1": "char", "<u4": "uint"}
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property {types[dt.fields[nm][0].str.replace('|', '')]} {nm}\n"
                  for nm in dt.names)
        + "end_header\n"
    )
    path = tmp_path / "mixed.ply"
    with open(path, "wb") as f:
        f.write(header.encode())
        data.tofile(f)
    got_native, native_path, got_numpy = _read_both(path)
    assert native_path == "native"
    _assert_bitwise(got_native, got_numpy)
    _assert_bitwise(got_native, jax_ply.read_ply(str(path), use_native=False))
    np.testing.assert_array_equal(got_native["red"], data["red"].astype(np.float32))
    # load_gaussians takes the DC colour from the uchar RGB on both sides
    mine = torch_ply.load_gaussians(str(path), device="cpu")
    theirs = jax_ply.load_gaussians(str(path))
    np.testing.assert_array_equal(mine.sh.detach().numpy(), np.asarray(theirs.sh))


@pytest.mark.parametrize("native_lib", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("sh_degree,n", [(0, 5), (3, 70_001)])
def test_writer_bytes_equal_the_jax_writer(tmp_path, monkeypatch, native_lib, sh_degree, n):
    leaves = convert.random_leaves(sh_degree, n, sh_degree=sh_degree)
    if not native_lib:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    mine, theirs = tmp_path / "torch.ply", tmp_path / "jax.ply"
    torch_ply.save_gaussians(str(mine), convert.model_from_numpy(leaves, "cpu"))
    jax_ply.save_gaussians(str(theirs), JaxModel.create(**leaves))
    assert mine.read_bytes() == theirs.read_bytes()


def test_failed_build_warns_once_and_reads_by_numpy(tmp_path, monkeypatch, capfd):
    leaves = convert.random_leaves(3, 50)
    path = tmp_path / "scene.ply"
    jax_ply.save_gaussians(str(path), JaxModel.create(**leaves))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setenv("PATH", "")  # no g++
    for _ in range(2):
        got = torch_ply.read_ply(str(path))
        assert torch_ply.last_read_path == "numpy"
    err = capfd.readouterr().err
    assert err.count("cannot build or load") == 1, err
    _assert_bitwise(got, jax_ply.read_ply(str(path), use_native=False))
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_lives_in_the_build_directory():
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "_build"
    assert not list(native.SRC.parent.glob("*.so"))  # nothing beside the source
