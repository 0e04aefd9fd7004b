"""What the port may import, and how it behaves on a machine without a GPU."""

import ast
import pathlib
import re
import subprocess
import sys
import tomllib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "gaussian_splat_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

JAX_FAMILY = {"jax", "jaxlib", "flax", "optax", "orbax"}
# import name -> distribution name in pyproject's dependencies
DIST_OF = {"torch": "torch", "numpy": "numpy", "PIL": "pillow"}


def _imports(path, top_level_only=False):
    """(module name, is_relative) for each import in the file."""
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_level_only else ast.walk(tree)
    found = []
    for node in nodes:
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
    return found


def _declared():
    with open(ROOT / "pyproject.toml", "rb") as f:
        deps = tomllib.load(f)["project"]["dependencies"]
    return {re.split(r"[<>=!\[; ]", d)[0].lower() for d in deps}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in JAX_FAMILY, f"{path.name} imports {mod}"
        assert top != "gaussian_splat_tpu", f"{path.name} imports {mod}"
    for mod in _imports(path, top_level_only=True):
        assert mod.split(".")[0] != "triton", f"{path.name} imports triton at module level"


def test_third_party_imports_are_declared():
    declared = _declared()
    stdlib = set(sys.stdlib_module_names)
    for path in SOURCES:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in stdlib or top == "gaussian_splat_tpu_torch":
                continue
            assert top in DIST_OF, f"{path.name}: unknown third-party import {mod}"
            assert DIST_OF[top] in declared, f"{mod} missing from pyproject dependencies"


def test_pyproject_ships_the_port_and_its_kernel_sources():
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)
    assert "gaussian_splat_tpu*" in data["tool"]["setuptools"]["packages"]["find"]["include"]
    pkg_data = data["tool"]["setuptools"]["package-data"]["gaussian_splat_tpu_torch"]
    assert "csrc/*.cu" in pkg_data and "csrc/*.cuh" in pkg_data
    for name in ("raster_fwd.cu", "raster_bwd.cu", "rank_perm.cu", "segsum.cu", "sh.cu",
                 "raster_common.cuh"):
        assert (PKG / "csrc" / name).exists(), name
    # the native PLY loader's source is the port's own copy, shipped as data
    assert data["tool"]["setuptools"]["package-data"]["gaussian_splat_tpu_torch.native"] == ["*.cpp"]
    own = PKG / "native" / "gsply.cpp"
    assert own.exists() and own != ROOT / "gaussian_splat_tpu" / "native" / "gsply.cpp"
    assert "gaussian_splat_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_import_needs_no_nvcc_and_no_jax():
    """A fresh interpreter with an empty PATH imports every module of the port,
    loads nothing of JAX, and builds nothing."""
    code = (
        "import sys, importlib, pkgutil, gaussian_splat_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'triton', 'gaussian_splat_tpu')]\n"
        "assert not bad, bad\n"
        "from gaussian_splat_tpu_torch import _build\n"
        "assert not _build.BUILD_DIR.exists() or not list(_build.BUILD_DIR.glob('*.so'))\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env={"PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from gaussian_splat_tpu_torch import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.load_library("raster_fwd")
    assert _build.kernel_names() == ["binning", "projection", "rank_perm", "raster_bwd",
                                     "raster_fwd", "segsum", "sh"]
    for name in _build.kernel_names():
        with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
            _build.load_library(name)
        assert _build.library_path(name).name.startswith(f"{name}-")


def test_library_name_follows_the_shared_header(monkeypatch, tmp_path):
    """An edited header must rebuild every kernel that includes it."""
    import shutil

    from gaussian_splat_tpu_torch import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {n: _build.library_path(n).name for n in _build.kernel_names()}
    with open(csrc / "raster_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n).name for n in _build.kernel_names()}
    assert all(before[n] != after[n] for n in ("raster_fwd", "raster_bwd"))


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a GPU")
    from gaussian_splat_tpu_torch import Camera, GaussianModel
    from gaussian_splat_tpu_torch.io.ply import load_gaussians
    from gaussian_splat_tpu_torch.viewer.viewer import Viewer

    ply = str(ROOT / "tests" / "golden" / "scene.ply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GaussianModel.random(torch.Generator().manual_seed(0), 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Camera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_gaussians(ply)
    model = load_gaussians(ply, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Viewer(model, show_overlay=False)
