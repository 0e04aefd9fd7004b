"""PLY scene reader and writer in the 3DGS convention.

Counterpart of gaussian_splat_tpu/io/ply.py. Binary payloads go through the
port's native multithreaded (de)interleaver (native/gsply.cpp, built with g++
on first use) and, where it cannot be built, through numpy; both give the
same arrays and the same bytes. `last_read_path` says which path the last
`read_ply` took ("native", "numpy" or "ascii"). Parameters stay RAW: logits,
log-scales and SH coefficients are stored as they are and activated in the
forward pass. Mixed property dtypes are honored via a numpy structured dtype
(numpy path) or a per-column conversion (native path).

SH `f_rest` layout is channel-major per the 3DGS ecosystem: for degree D with
K=(D+1)² bases, `f_rest_{c·(K−1)+i}` is channel c, band coefficient i+1.
"""

from __future__ import annotations

import ctypes
import io
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from gaussian_splat_tpu_torch import native
from gaussian_splat_tpu_torch._device import DeviceLike
from gaussian_splat_tpu_torch.models.gaussians import GaussianModel
from gaussian_splat_tpu_torch.ops.sh import num_sh_bases, rgb_to_sh_dc

_PLY_TO_NUMPY = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "<i2",
    "int16": "<i2",
    "ushort": "<u2",
    "uint16": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def _parse_header(f) -> Tuple[int, list, bool, int]:
    """Returns (vertex_count, [(name, dtype_str)], is_binary, header_len).
    Only the `vertex` element is read; other elements after it are ignored."""
    raw = f.read(64 * 1024)
    end = raw.find(b"end_header")
    if end < 0:
        raise ValueError("not a PLY file: no end_header in first 64KiB")
    end = raw.index(b"\n", end) + 1
    header = raw[:end].decode("ascii", errors="replace")
    lines = [ln.strip() for ln in header.splitlines()]
    if not lines or lines[0] != "ply":
        raise ValueError("not a PLY file: missing 'ply' magic")

    is_binary = True
    vertex_count = 0
    props: list = []
    in_vertex = False
    for ln in lines[1:]:
        parts = ln.split()
        if not parts:
            continue
        if parts[0] == "format":
            if parts[1] == "binary_little_endian":
                is_binary = True
            elif parts[1] == "ascii":
                is_binary = False
            else:
                raise ValueError(f"unsupported PLY format {parts[1]!r}")
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                vertex_count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported on vertex element")
            name = parts[-1]
            dt = _PLY_TO_NUMPY.get(parts[1])
            if dt is None:
                raise ValueError(f"unsupported property type {parts[1]!r}")
            props.append((name, dt))
    return vertex_count, props, is_binary, end


# which path the newest read_ply took: "native", "numpy" or "ascii"
last_read_path: Optional[str] = None


def _threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _read_binary_native(
    path: str, n: int, props, header_len: int, stride: int, lib
) -> Dict[str, np.ndarray]:
    """Multithreaded column extraction by native/gsply.cpp, which converts
    every dtype `_parse_header` admits."""
    enums = [native.DTYPE_ENUM[dt] for _, dt in props]
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=header_len)
    if mm.size < n * stride:
        raise ValueError(
            f"PLY truncated: expected {n} vertices ({n * stride} bytes), "
            f"got {mm.size} bytes"
        )
    outs = {name: np.empty(n, np.float32) for name, _ in props}
    offsets = np.zeros(len(props), np.int64)
    acc = 0
    for i, (_, dt) in enumerate(props):
        offsets[i] = acc
        acc += np.dtype(dt).itemsize
    dts = np.asarray(enums, np.int32)
    ptrs = (ctypes.c_void_p * len(props))(*[o.ctypes.data for o in outs.values()])
    lib.gsply_deinterleave(
        ctypes.cast(mm.ctypes.data, ctypes.c_char_p),
        ctypes.c_int64(n),
        ctypes.c_int64(stride),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(props)),
        ptrs,
        ctypes.c_int32(_threads()),
    )
    del mm
    return outs


def read_ply(path: str, use_native: bool = True) -> Dict[str, np.ndarray]:
    """Read all vertex properties into a dict of (N,) float32 numpy arrays
    (uchar colors are converted losslessly).

    Binary files go through the native deinterleaver unless `use_native` is
    False or the library cannot be built (one warning on stderr); then
    through a numpy structured dtype. Both give bitwise the same arrays."""
    global last_read_path
    with open(path, "rb") as f:
        n, props, is_binary, header_len = _parse_header(f)
        if is_binary:
            stride = int(sum(np.dtype(dt).itemsize for _, dt in props))
            lib = native.get_lib() if use_native and n > 0 else None
            if lib is not None:
                last_read_path = "native"
                return _read_binary_native(path, n, props, header_len, stride, lib)
            f.seek(header_len)
            data = np.fromfile(f, dtype=np.dtype(props), count=n)
            if data.shape[0] != n:
                raise ValueError(
                    f"PLY truncated: expected {n} vertices, got {data.shape[0]}"
                )
            last_read_path = "numpy"
        else:
            f.seek(header_len)
            flat = np.loadtxt(io.TextIOWrapper(f, "ascii"), max_rows=n, ndmin=2)
            if flat.shape != (n, len(props)):
                raise ValueError(
                    f"ASCII PLY shape mismatch: {flat.shape} vs {(n, len(props))}"
                )
            data = np.zeros(n, dtype=np.dtype([(p, "<f8") for p, _ in props]))
            for i, (name, _) in enumerate(props):
                data[name] = flat[:, i]
            last_read_path = "ascii"
    return {
        name: np.ascontiguousarray(data[name]).astype(np.float32)
        for name, _ in props
    }


def _stack(fields: Dict[str, np.ndarray], names, default=None) -> Optional[np.ndarray]:
    if all(nm in fields for nm in names):
        return np.stack([fields[nm].astype(np.float32) for nm in names], axis=-1)
    return default


def load_gaussians(
    path: str, max_sh_degree: int = 3, device: DeviceLike = None
) -> GaussianModel:
    """Load a 3DGS PLY as a GaussianModel with RAW (trainable) parameters.

    Defaults for absent fields, in raw space: opacity logit 9.21 (sigmoid ≈
    0.9999), log-scale log(0.01), identity quaternion."""
    fields = read_ply(path)
    n = len(next(iter(fields.values())))

    means = _stack(fields, ["x", "y", "z"])
    if means is None:
        raise ValueError("PLY missing x/y/z positions")

    quats = _stack(fields, ["rot_0", "rot_1", "rot_2", "rot_3"])
    if quats is None:
        quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1))

    log_scales = _stack(fields, ["scale_0", "scale_1", "scale_2"])
    if log_scales is None:
        log_scales = np.full((n, 3), math.log(0.01), np.float32)

    if "opacity" in fields:
        opacity_logits = fields["opacity"].astype(np.float32)
    else:
        opacity_logits = np.full((n,), 9.21, np.float32)

    # --- SH coefficients ---------------------------------------------------
    n_rest = 0
    while f"f_rest_{n_rest}" in fields:
        n_rest += 1
    rest_per_channel = n_rest // 3
    degree = 0
    while num_sh_bases(degree + 1) - 1 <= rest_per_channel and degree < max_sh_degree:
        degree += 1
    K = num_sh_bases(degree)

    sh = np.zeros((n, K, 3), np.float32)
    dc = _stack(fields, ["f_dc_0", "f_dc_1", "f_dc_2"])
    if dc is not None:
        sh[:, 0, :] = dc
    else:
        rgb = _stack(fields, ["red", "green", "blue"])
        if rgb is not None:
            sh[:, 0, :] = rgb_to_sh_dc(rgb / 255.0)
    for c in range(3):
        for i in range(K - 1):
            key = f"f_rest_{c * rest_per_channel + i}"
            if key in fields:
                sh[:, 1 + i, c] = fields[key].astype(np.float32)

    return GaussianModel.create(
        means, quats, log_scales, opacity_logits, sh, device=device
    )


def save_gaussians(path: str, model: GaussianModel) -> None:
    """Write a binary_little_endian 3DGS PLY (raw parameters; round-trips
    `load_gaussians`, and byte for byte the file the JAX package's writer
    makes of the same parameters)."""
    n = model.num_gaussians
    rest = model.sh.shape[1] - 1

    names = (
        ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(rest * 3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )

    def host(x):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)

    means, sh = host(model.means), host(model.sh)
    ls, q = host(model.log_scales), host(model.quats)
    zeros = np.zeros(n, np.float32)
    cols: Dict[str, np.ndarray] = {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "nx": zeros, "ny": zeros, "nz": zeros,
        "f_dc_0": sh[:, 0, 0], "f_dc_1": sh[:, 0, 1], "f_dc_2": sh[:, 0, 2],
        "opacity": host(model.opacity_logits),
        "scale_0": ls[:, 0], "scale_1": ls[:, 1], "scale_2": ls[:, 2],
        "rot_0": q[:, 0], "rot_1": q[:, 1], "rot_2": q[:, 2], "rot_3": q[:, 3],
    }
    for c in range(3):
        for i in range(rest):
            cols[f"f_rest_{c * rest + i}"] = sh[:, 1 + i, c]

    # interleave columns → rows: native multithreaded path when available
    col_list = [np.ascontiguousarray(cols[nm], np.float32) for nm in names]
    lib = native.get_lib() if n > 0 else None
    if lib is not None:
        flat = np.empty((n, len(names)), np.float32)
        ptrs = (ctypes.c_void_p * len(names))(*[c.ctypes.data for c in col_list])
        lib.gsply_interleave_f32(
            ptrs,
            ctypes.c_int64(n),
            ctypes.c_int32(len(names)),
            ctypes.c_void_p(flat.ctypes.data),
            ctypes.c_int32(_threads()),
        )
    else:
        flat = np.stack(col_list, axis=1) if n > 0 else np.zeros((0, len(names)), np.float32)

    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {nm}\n" for nm in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        flat.tofile(f)
