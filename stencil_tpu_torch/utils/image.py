"""Heat-map image output: a 24-bit BMP with a blue->green->red ramp.

Counterpart of ``stencil_tpu/utils/image.py`` (``colorize``, ``write_bmp``,
``colorize_native``, ``write_bmp_native``, ``dump_heatmap``): the same
bytes for the same field. The CLI's ``--dump-image`` writes the final
iterate through :func:`dump_heatmap`, from the host: the native C++ writer
(``native/bmp.cpp``, built with g++ on first use) where it builds, the
Python one otherwise, as the JAX package chooses.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def colorize(values: np.ndarray, vmin: float = 0.0,
             vmax: float = 1.0) -> np.ndarray:
    """Scalars to RGB uint8 by the 4-segment ramp blue -> cyan (0.25) ->
    green -> yellow -> red over [vmin, vmax], clamped, channels truncated
    to uint8."""
    span = (vmax - vmin) if vmax > vmin else 1.0
    v = np.clip((np.asarray(values, dtype=np.float64) - vmin) / span,
                0.0, 1.0)
    r = np.where(v < 0.5, 0.0, np.where(v < 0.75, 4.0 * (v - 0.5), 1.0))
    g = np.where(v < 0.25, 4.0 * v,
                 np.where(v < 0.75, 1.0, 1.0 + 4.0 * (0.75 - v)))
    b = np.where(v < 0.25, 1.0,
                 np.where(v < 0.5, 1.0 + 4.0 * (0.25 - v), 0.0))
    rgb = np.stack([r, g, b], axis=-1)
    return np.trunc(rgb * 255.0).astype(np.uint8)


def write_bmp(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB array as an uncompressed 24-bit BMP: the
    14-byte file header and the 40-byte info header, rows bottom-up and
    padded to 4 bytes, pixels BGR."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    row_bytes = w * 3
    pad = (-row_bytes) % 4
    image_size = (row_bytes + pad) * h
    data_offset = 14 + 40
    header = struct.pack(
        "<2sIHHI", b"BM", data_offset + image_size, 0, 0, data_offset
    ) + struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, image_size, 2835, 2835, 0, 0)
    bgr = rgb[::-1, :, ::-1]
    if pad:
        rows = np.zeros((h, row_bytes + pad), dtype=np.uint8)
        rows[:, :row_bytes] = bgr.reshape(h, row_bytes)
        body = rows.tobytes()
    else:
        body = bgr.tobytes()
    Path(path).write_bytes(header + body)


def colorize_native(values: np.ndarray, vmin: float = 0.0,
                    vmax: float = 1.0):
    """:func:`colorize` by the native library, byte for byte; None when it
    does not build."""
    from stencil_tpu_torch import native

    lib = native.load_bmp()
    if lib is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.float64)
    out = np.empty(v.shape + (3,), dtype=np.uint8)
    lib.stencil_colorize(v.ctypes.data, v.size, float(vmin), float(vmax),
                         out.ctypes.data)
    return out


def write_bmp_native(path, rgb: np.ndarray) -> bool:
    """:func:`write_bmp` by the native library; False when it does not
    build."""
    from stencil_tpu_torch import native

    lib = native.load_bmp()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    rc = lib.stencil_bmp_write(str(path).encode(), rgb.ctypes.data, h, w)
    if rc != 0:
        raise OSError(f"native BMP write failed with code {rc}")
    return True


def dump_heatmap(path, values, vmin: float = 0.0, vmax: float = 1.0) -> None:
    """Colorize a 2D field, or the middle d0 slice of a 3D one (a numpy
    array or a tensor on any device), and write it as a BMP."""
    if hasattr(values, "detach"):  # a torch tensor: to the host, float64
        values = values.detach().double().cpu().numpy()
    values = np.asarray(values)
    if values.ndim == 3:
        values = values[values.shape[0] // 2]
    if values.ndim != 2:
        raise ValueError(f"expected 2D or 3D field, got shape {values.shape}")
    rgb = colorize_native(values, vmin, vmax)
    if rgb is None:
        write_bmp(path, colorize(values, vmin, vmax))
        return
    if not write_bmp_native(path, rgb):
        write_bmp(path, rgb)
