"""The port's `cli validate` and `cli view` on the CPU."""

import io
import json
import os
import pathlib
import queue
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
from PIL import Image

from gaussian_splat_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLY = str(ROOT / "tests" / "golden" / "scene.ply")
TIMEOUT = 120  # seconds: start-up, each request, the shutdown


def test_cli_validate_on_the_cpu(capsys):
    assert cli.main(["validate", PLY, "--device", "cpu", "--sample", "500"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("OK  torch_tile")
    assert out[1].startswith("SKIP cuda")  # no CUDA device: said, not hidden


def test_cli_validate_fails_past_its_tolerance(capsys):
    assert cli.main(["validate", PLY, "--device", "cpu", "--sample", "300",
                     "--tol", "1e-12"]) == 1
    assert "FAIL torch_tile" in capsys.readouterr().out


def test_cli_info_takes_the_aabb_clip(capsys):
    assert cli.main(["info", PLY, "--device", "cpu", "--aabb-clip", "0.5"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert 0 < stats["num_gaussians"] < 2000
    assert max(abs(v) for v in stats["means_min"] + stats["means_max"]) < 0.5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_view_serves_a_frame():
    port = _free_port()
    cmd = [sys.executable, "-m", "gaussian_splat_tpu_torch.cli", "view", PLY,
           "--device", "cpu", "--port", str(port), "--width", "64", "--height", "48",
           "--lod-pairs", "0.3"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        try:
            line = lines.get(timeout=TIMEOUT)
        except queue.Empty:
            proc.kill()
            raise AssertionError(f"no serving line: {proc.communicate(timeout=TIMEOUT)[1]}")
        assert line.startswith("serving 2000 splats on cpu") and f":{port}/" in line, line
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/frame", timeout=TIMEOUT) as r:
            body = r.read()
        assert r.headers.get("Content-Type") == "image/jpeg" and body[:3] == b"\xff\xd8\xff"
        assert np.asarray(Image.open(io.BytesIO(body))).shape == (48, 64, 3)
        with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT) as r:
            assert json.loads(r.read())["num_gaussians"] == 2000
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
    assert proc.returncode is not None
