"""ctypes bindings for the native prefetching dataset loader.

A copy of `vslam_tpu.io.native_loader` (numpy and ctypes), except where the
library lives: the port builds `native/vslam_io.cpp` (C++17, zlib only) with
g++ into `build/vslam_tpu_torch/libvslam_io.so` (git-ignored) at first use,
and never writes into `native/`. This is host PNG decoding, not the device
path: where the library does not build, callers fall back to PIL, as the
JAX package's do.

Worker threads decode (rgb, depth) PNG pairs ahead of the consumer into a
bounded in-order queue (NodeReplayer/Queue semantics without DDS).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["NativeFrameLoader", "native_available", "decode_png"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "vslam_io.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "vslam_tpu_torch", "libvslam_io.so")
_lib = None
_build_attempted = False


def _ensure_built():
    """Build the library on first use when it is absent: one g++ of one
    small file against zlib, a few seconds. A failed or missing toolchain
    leaves the native path unavailable (callers fall back to PIL)."""
    global _build_attempted
    if os.path.exists(_LIB_PATH) or _build_attempted:
        return
    _build_attempted = True
    if not os.path.exists(_SOURCE):
        return
    try:
        import subprocess

        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        done = subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, _SOURCE,
             "-lz", "-lpthread"],
            capture_output=True, timeout=120, check=False,
        )
        if done.returncode == 0:
            os.replace(tmp, _LIB_PATH)
    except Exception:
        pass


def _load():
    global _lib
    if _lib is None:
        _ensure_built()
    if _lib is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.vslam_loader_open.restype = ctypes.c_void_p
        lib.vslam_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
        ]
        lib.vslam_loader_next.restype = ctypes.c_int
        lib.vslam_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.vslam_loader_close.argtypes = [ctypes.c_void_p]
        lib.vslam_loader_open_raw.restype = ctypes.c_void_p
        lib.vslam_loader_open_raw.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vslam_loader_next_raw.restype = ctypes.c_int
        lib.vslam_loader_next_raw.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.vslam_decode_png_f32.restype = ctypes.c_int
        lib.vslam_decode_png_f32.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_float,
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def decode_png(path: str, scale16: float = 1.0, max_pixels: int = 4096 * 4096) -> np.ndarray:
    """Decode a PNG to float32 via the native library (8-bit gray/RGB(A) ->
    [0,255] luma; 16-bit gray scaled by scale16)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (make -C native)")
    buf = np.empty(max_pixels, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.vslam_decode_png_f32(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(h),
        ctypes.byref(w),
        max_pixels,
        ctypes.c_float(scale16),
    )
    if rc != 0:
        raise IOError(f"PNG decode failed ({rc}): {path}")
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class NativeFrameLoader:
    """In-order prefetching (gray, depth) frame stream."""

    def __init__(
        self,
        rgb_paths: List[str],
        depth_paths: List[str],
        depth_scale: float = 1.0 / 5000.0,
        n_threads: int = 2,
        capacity: int = 8,
        max_pixels: int = 4096 * 4096,
        raw: bool = False,
    ):
        """``raw=True`` streams native sensor dtypes — (u8 gray, u16 depth
        counts) — for the pipeline's u8/u16 host->device transport; the f32
        conversion and depth scaling then happen ON DEVICE
        (PipelineConfig.depth_scale / SequentialConfig.depth_scale)."""
        lib = _load()
        if lib is None:
            raise RuntimeError("native library not built (make -C native)")
        assert len(rgb_paths) == len(depth_paths)
        self._lib = lib
        self._n = len(rgb_paths)
        self._max_pixels = max_pixels
        self._raw = raw
        rgb_arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in rgb_paths])
        depth_arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        self._keepalive = (rgb_arr, depth_arr)
        if raw:
            self._h = lib.vslam_loader_open_raw(
                rgb_arr, depth_arr, self._n, n_threads, capacity
            )
        else:
            self._h = lib.vslam_loader_open(
                rgb_arr, depth_arr, self._n, n_threads, capacity,
                ctypes.c_float(depth_scale),
            )

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self._raw:
            yield from self._iter_raw()
            return
        gray = np.empty(self._max_pixels, np.float32)
        depth = np.empty(self._max_pixels, np.float32)
        h = ctypes.c_int()
        w = ctypes.c_int()
        while True:
            rc = self._lib.vslam_loader_next(
                self._h,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(h),
                ctypes.byref(w),
                self._max_pixels,
            )
            if rc == -1:
                return
            if rc != 0:
                raise IOError(f"frame decode failed ({rc})")
            n = h.value * w.value
            yield (
                gray[:n].reshape(h.value, w.value).copy(),
                depth[:n].reshape(h.value, w.value).copy(),
            )

    def _iter_raw(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        gray = np.empty(self._max_pixels, np.uint8)
        depth = np.empty(self._max_pixels, np.uint16)
        h = ctypes.c_int()
        w = ctypes.c_int()
        while True:
            rc = self._lib.vslam_loader_next_raw(
                self._h,
                gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                ctypes.byref(h),
                ctypes.byref(w),
                self._max_pixels,
            )
            if rc == -1:
                return
            if rc != 0:
                raise IOError(f"raw frame decode failed ({rc})")
            n = h.value * w.value
            yield (
                gray[:n].reshape(h.value, w.value).copy(),
                depth[:n].reshape(h.value, w.value).copy(),
            )

    def close(self):
        if self._h:
            self._lib.vslam_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
