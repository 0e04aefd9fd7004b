"""The port's utils: kernel hot reload, timing and profiler trace, numerics
guards, and the H100 roofline."""

import os
import time

import numpy as np
import pytest
import torch

from gaussian_splat_tpu.camera import Camera as JaxCamera
from gaussian_splat_tpu_torch import _build, convert
from gaussian_splat_tpu_torch.utils import guards, roofline
from gaussian_splat_tpu_torch.utils.hot_reload import HotReloader
from gaussian_splat_tpu_torch.utils.timing import time_fn, trace

W, H = 48, 32


# -- hot reload -----------------------------------------------------------------


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """csrc/ in a temporary directory, and a build that "compiles" each .cu
    into the text it holds (a source with `#error` fails to compile), so the
    reloader's logic runs without nvcc."""
    src = tmp_path / "csrc"
    src.mkdir()
    built = []

    def build_libraries(src_dir=None, build_dir=None):
        libs = {}
        for path in sorted(src_dir.glob("*.cu")):
            text = path.read_text()
            if "#error" in text:
                raise _build.KernelCompileError(f"nvcc failed on {path.name}")
            libs[path.stem] = text
        built.append(libs)
        return libs

    monkeypatch.setattr(_build, "build_libraries", build_libraries)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_retired", [])
    return src, built


def _edit(path, text, bump):
    path.write_text(text)
    now = time.time() + bump  # a new mtime even on a coarse clock
    os.utime(path, (now, now))


def test_hot_reload_keeps_last_good(fake_build):
    """Mirrors tests/test_utils.py's hot-reload test: a good edit is picked
    up, a broken one (compile error, then a failing probe) keeps the last good
    build installed."""
    src, built = fake_build
    kernel = src / "k.cu"
    kernel.write_text("x + 1")
    probed = []

    def probe():
        lib = _build.load_library("k")  # the candidate, on this thread only
        probed.append(lib)
        if "probe-fails" in lib:
            raise RuntimeError("bad frame")

    r = HotReloader(probe=probe, src_dir=src, verbose=False)
    assert _build._libs == {"k": "x + 1"} and probed == ["x + 1"]
    assert not r.check()  # nothing changed: no rebuild
    assert len(built) == 1

    _edit(kernel, "x + 10", 5)
    assert r.check() and _build._libs["k"] == "x + 10"
    assert _build._retired == ["x + 1"] and r.reloads == 1

    _edit(kernel, "#error boom", 10)
    assert not r.check() and _build._libs["k"] == "x + 10"
    assert r.failures == 1 and "KernelCompileError" in r.last_error

    _edit(kernel, "probe-fails", 15)
    assert not r.check() and _build._libs["k"] == "x + 10"
    assert probed[-1] == "probe-fails" and "bad frame" in r.last_error

    # a header edit is a change too
    _edit(kernel, "x + 100", 20)
    assert r.check() and _build._libs["k"] == "x + 100"
    _edit(src / "common.cuh", "// header", 25)
    assert r.check() and r.reloads == 3


def test_hot_reload_first_build_raises(fake_build):
    src, _ = fake_build
    (src / "k.cu").write_text("#error at the start")
    with pytest.raises(_build.KernelCompileError):
        HotReloader(src_dir=src)
    (src / "k.cu").write_text("fine")

    def probe():
        raise RuntimeError("the probe frame failed")

    with pytest.raises(RuntimeError, match="probe frame"):
        HotReloader(probe=probe, src_dir=src)
    assert _build._libs == {}


def test_hot_reload_prints_a_refused_build(fake_build, capsys):
    src, _ = fake_build
    (src / "k.cu").write_text("fine")
    r = HotReloader(src_dir=src)
    _edit(src / "k.cu", "#error now", 5)
    assert not r.check()
    err = capsys.readouterr().err
    assert "rebuild failed" in err and "keeping the last good build" in err


def test_using_routes_one_thread_only(monkeypatch):
    import threading

    monkeypatch.setattr(_build, "_libs", {"k": "installed"})
    seen = {}
    with _build.using({"k": "trial"}):
        seen["here"] = _build.load_library("k")
        t = threading.Thread(target=lambda: seen.__setitem__("there", _build.load_library("k")))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen == {"here": "trial", "there": "installed"}
    assert _build.load_library("k") == "installed"


def test_build_and_library_dirs_are_arguments(tmp_path):
    import shutil

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    names = _build.kernel_names(src)
    assert names == _build.kernel_names()
    same = {n: _build.library_path(n, src, tmp_path / "b").name for n in names}
    assert same == {n: _build.library_path(n).name for n in names}
    assert _build.library_path("raster_fwd", src, tmp_path / "b").parent == tmp_path / "b"
    with open(src / "raster_fwd.cu", "a") as f:
        f.write("// a comment\n")
    assert _build.library_path("raster_fwd", src).name != same["raster_fwd"]
    assert _build.library_path("segsum", src).name == same["segsum"]


# -- timing ---------------------------------------------------------------------


def test_time_fn_returns_the_median():
    calls = []
    ms = time_fn(lambda x: calls.append(x) or time.sleep(0.002), 1, warmup=1, iters=3)
    assert ms >= 1.5 and calls == [1] * 4


def test_trace_none_is_a_no_op():
    with trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names or "aten::matmul" in names
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


# -- guards ---------------------------------------------------------------------


def _scene():
    leaves = convert.random_leaves(0, 64, sh_degree=0)
    jc = JaxCamera.from_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0), 60.0, W, H)
    tc = convert.camera_from_numpy(
        np.asarray(jc.viewmat), jc.fx, jc.fy, jc.cx, jc.cy, W, H, device="cpu"
    )
    return leaves, jc, tc


def test_checked_render_and_grads_clean_scene():
    """On a clean scene the guards return what the unguarded torch_tile
    path returns, bit for bit, and leave no .grad on the model."""
    from gaussian_splat_tpu_torch.config import RenderConfig
    from gaussian_splat_tpu_torch.ops.render import render

    leaves, _, tc = _scene()
    model = convert.model_from_numpy(leaves, "cpu")
    cfg = RenderConfig(backend="torch_tile")
    img = guards.checked_render(model, tc, device="cpu")
    with torch.no_grad():
        assert torch.equal(img, render(model, tc, cfg).image)
    grads = guards.checked_grads(model, tc, device="cpu")
    assert guards.find_nonfinite(grads) == ()
    for name in model.LEAVES:
        assert getattr(model, name).grad is None
    torch.mean(render(model, tc, cfg).image ** 2).backward()
    for name in model.LEAVES:
        assert torch.equal(grads[name], getattr(model, name).grad), name
        assert bool(grads[name].abs().max() > 0) or name == "quats"


@pytest.mark.parametrize("leaf,index,stage", [
    ("means", (3, 0), "projection"),
    ("sh", (5, 0, 1), "colours"),
])
def test_checked_render_names_the_stage(leaf, index, stage):
    leaves, _, tc = _scene()
    leaves[leaf][index] = np.nan
    model = convert.model_from_numpy(leaves, "cpu")
    with pytest.raises(FloatingPointError, match=stage):
        guards.checked_render(model, tc, device="cpu")
    with pytest.raises((FloatingPointError, RuntimeError)):
        guards.checked_grads(model, tc, device="cpu")


def test_checked_render_checks_binning_and_composite(monkeypatch):
    """A NaN that appears only in the binned table, or only in the image."""
    from gaussian_splat_tpu_torch.ops import tile_raster

    leaves, _, tc = _scene()
    model = convert.model_from_numpy(leaves, "cpu")
    real_table = tile_raster.build_splat_table

    def bad_table(*a, **k):
        t = real_table(*a, **k)
        t[0, 0] = float("inf")
        return t

    monkeypatch.setattr(tile_raster, "build_splat_table", bad_table)
    with pytest.raises(FloatingPointError, match="binning"):
        guards.checked_render(model, tc, device="cpu")
    monkeypatch.setattr(tile_raster, "build_splat_table", real_table)
    real_raster = tile_raster.raster_forward_torch

    def bad_raster(*a, **k):
        rgbd, t = real_raster(*a, **k)
        return rgbd, t * float("nan")

    monkeypatch.setattr(tile_raster, "raster_forward_torch", bad_raster)
    with pytest.raises(FloatingPointError, match="composite"):
        guards.checked_render(model, tc, device="cpu")


def test_find_nonfinite():
    leaves, _, _ = _scene()
    model = convert.model_from_numpy(leaves, "cpu")
    assert guards.find_nonfinite(model) == ()
    with torch.no_grad():
        model.log_scales[2, 1] = float("inf")
        model.sh[0, 0, 0] = float("nan")
    assert guards.find_nonfinite(model, "m") == ("m.log_scales", "m.sh")
    tree = {"a": torch.ones(3), "b": torch.tensor([1.0, float("nan")]),
            "i": torch.arange(3)}
    assert guards.find_nonfinite(tree) == ("['b']",)
    assert guards.find_nonfinite(torch.tensor(float("inf")), "x") == ("x",)


# -- roofline -------------------------------------------------------------------


def test_roofline_reproduces_the_recorded_bounds():
    """The bench_full case of the kernels line (1M splats, 1920x1080, 32x16
    tiles, 2,459,529 pairs): the counts printed beside each bound give
    exactly the bound printed. segsum's counts an int32 permutation; with the
    int64 one that the kernel read before, the same case gave 189,733,628 B
    and 0.056636903880597014 ms."""
    n, pairs, tiles, w, h = 1_000_000, 2_459_529, 60 * 68, 1920, 1080
    steps, kept = 742_572_032, 111_119_813
    fwd = roofline.forward_cost(n, pairs, tiles, w, h, steps, kept)
    assert (fwd.bytes, fwd.flops) == (99_342_756, 8_238_825_670)
    assert fwd.attainable_ms() == 0.12296754731343283
    assert fwd.limiter() == "operations" and fwd.bytes_ms == 0.029654554029850747
    bwd = roofline.backward_cost(n, pairs, tiles, w, h, 3_119_104, steps, kept)
    assert (bwd.bytes, bwd.flops) == (290_548_068, 13_128_097_442)
    assert bwd.attainable_ms() == 0.19594175286567164
    assert bwd.bytes_ms == 0.08673076656716418
    seg = roofline.segsum_cost(n, pairs)
    assert seg.bytes == 179_895_512
    assert seg.attainable_ms() == 0.05370015283582089 and seg.limiter() == "bytes"
    f = seg.fields()
    assert f["bound_ms"] == seg.attainable_ms() and f["bound_by"] == "bytes"
    assert f["ops_ms"] == pairs * 12 / 67e12 * 1e3
    # the SH kernels' bench_full and rubble_rows cases (K = 16, degree 3):
    # 216 and 420 bytes a row, 11.2M rows 2.42 and 4.70 GB
    assert roofline.sh_forward_cost(n, 3).bytes == 216_000_000
    assert roofline.sh_backward_cost(n, 16, 3).bytes == 420_000_000
    rows = 11_200_000
    assert roofline.sh_forward_cost(rows, 3).attainable_ms() == 0.7221492537313433
    assert roofline.sh_backward_cost(rows, 16, 3).attainable_ms() == 1.404179104477612
    assert roofline.sh_backward_cost(rows, 16, 0).bytes == rows * (3 + 3 + 48 + 3) * 4


def test_binning_cost_counts_each_byte_once():
    """binning's chain at rubble's size: 41 bytes a splat read (means2d,
    extents, valid, conics, opacity, its rank in `order`), the kept bytes,
    the big rows' ranks, rank_starts, the tiles' offsets and counts, the
    sentinels and 12 bytes a pair slot written; without the σ test and with
    the radii, 21 bytes a splat."""
    n, tiles, budget, big = 11_200_000, 36 * 54, 14_000_000, 200_000
    cost = roofline.binning_cost(n, n, tiles, budget, 6, 256, big)
    assert cost.bytes == (n * 41 + n * 6 + big * 260 + (n + 1) * 4 + 2 * tiles * 4 + 20
                          + budget * 12)
    assert cost.flops == 0 and cost.limiter() == "bytes"
    assert 0.2 < cost.attainable_ms() < 0.4
    plain = roofline.binning_cost(n, n, tiles, budget, 6, 256, big, sigma_test=False,
                                  extents=False)
    assert cost.bytes - plain.bytes == n * 20
