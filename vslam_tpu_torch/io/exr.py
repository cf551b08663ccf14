"""Minimal OpenEXR scanline reader/writer (pure numpy + zlib).

A copy of `vslam_tpu.io.exr`: the same reader and the same bytes written.

The reference stores float depth maps as single-channel EXR files
(`utils::saveDepth` / `utils::loadDepth`, reference `utils.cpp:60-75`, via
OpenCV's EXR codec) and ships one as a test fixture
(`src/vslam/src/lukas_kanade/test/resource/sim.exr`). This module gives the
TPU rebuild the same capability without an OpenEXR dependency: it handles
single-part scanline images with NONE / ZIPS / ZIP compression and
HALF / FLOAT / UINT channels — the subset OpenCV emits — implemented from the
public OpenEXR file-format specification.

Reading returns (H, W) for one channel or (H, W, C) with channels in
file (alphabetical) order.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["read_exr", "write_exr"]

_MAGIC = 0x01312F76
# channel pixel types (spec)
_UINT, _HALF, _FLOAT = 0, 1, 2
_DTYPES = {_UINT: np.dtype("<u4"), _HALF: np.dtype("<f2"), _FLOAT: np.dtype("<f4")}
# compression codes
_NONE, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_BLOCK_LINES = {_NONE: 1, _ZIPS: 1, _ZIP: 16}


def _read_cstring(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes):
    magic, version = struct.unpack_from("<II", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    if version & 0x1000 or version & 0x800:
        raise NotImplementedError("multi-part / deep EXR not supported")
    off = 8
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while True:
        name, off = _read_cstring(buf, off)
        if not name:
            break
        typ, off = _read_cstring(buf, off)
        (size,) = struct.unpack_from("<I", buf, off)
        off += 4
        attrs[name] = (typ, buf[off : off + size])
        off += size
    return attrs, off


def _parse_channels(raw: bytes) -> List[Tuple[str, int]]:
    """Return [(name, pixel_type), ...] in file order (alphabetical)."""
    out = []
    off = 0
    while raw[off] != 0:
        end = raw.index(b"\0", off)
        name = raw[off:end].decode("latin-1")
        ptype, _plinear, _xs, _ys = struct.unpack_from("<IIII", raw, end + 1)
        out.append((name, ptype))
        off = end + 1 + 16
    return out


def _undo_exr_zip(data: bytes) -> bytes:
    """Invert OpenEXR's zip pre-filter: delta predictor then byte deinterleave."""
    raw = np.frombuffer(data, np.uint8).astype(np.int64).copy()
    # stored: d[0] = t[0], d[i] = t[i] - t[i-1] + 128  ->  t = cumsum(d - 128*[0,1,1,...])
    raw[1:] -= 128
    arr = np.cumsum(raw) % 256
    out = np.empty(arr.size, np.uint8)
    half = (arr.size + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _do_exr_zip(data: bytes) -> bytes:
    """Apply OpenEXR's zip pre-filter (interleave split + delta) for writing."""
    arr = np.frombuffer(data, np.uint8)
    half = (arr.size + 1) // 2
    tmp = np.empty(arr.size, np.uint8)
    tmp[:half] = arr[0::2]
    tmp[half:] = arr[1::2]
    t = tmp.astype(np.int64)
    d = np.empty_like(t)
    d[0] = t[0]
    d[1:] = t[1:] - t[:-1] + 128
    return (d % 256).astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR. Returns float32 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        buf = f.read()
    attrs, off = _parse_header(buf)
    channels = _parse_channels(attrs["channels"][1])
    (comp,) = struct.unpack_from("<B", attrs["compression"][1], 0)
    if comp not in _BLOCK_LINES:
        raise NotImplementedError(f"EXR compression code {comp} not supported")
    xmin, ymin, xmax, ymax = struct.unpack_from("<iiii", attrs["dataWindow"][1], 0)
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = _BLOCK_LINES[comp]
    n_blocks = (H + lines_per_block - 1) // lines_per_block

    # scanline offset table: n_blocks uint64 entries
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)
    bytes_per_px = sum(_DTYPES[pt].itemsize for _, pt in channels)

    out = {name: np.empty((H, W), np.float32) for name, _ in channels}
    for bi in range(n_blocks):
        boff = offsets[bi]
        y, size = struct.unpack_from("<iI", buf, boff)
        raw = buf[boff + 8 : boff + 8 + size]
        y0 = y - ymin
        n_lines = min(lines_per_block, H - y0)
        expect = n_lines * W * bytes_per_px
        if comp in (_ZIPS, _ZIP) and len(raw) != expect:
            # spec: blocks whose compressed size would not shrink are stored raw
            dec = zlib.decompress(raw)
            data = _undo_exr_zip(dec) if len(dec) == expect else dec
        else:
            data = raw
        # per scanline: channels in file order, each a full row
        pos = 0
        for li in range(n_lines):
            for name, pt in channels:
                dt = _DTYPES[pt]
                row = np.frombuffer(data, dt, count=W, offset=pos)
                out[name][y0 + li] = row.astype(np.float32)
                pos += W * dt.itemsize
    if len(channels) == 1:
        return out[channels[0][0]]
    return np.stack([out[name] for name, _ in channels], axis=-1)


def write_exr(path: str, img: np.ndarray, channel: str = "Y") -> None:
    """Write a single-channel float32 EXR with ZIP compression (the format
    `utils::saveDepth` produces via OpenCV; reference `utils.cpp`)."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError("write_exr expects a single-channel (H, W) array")
    H, W = img.shape

    def attr(name: str, typ: str, val: bytes) -> bytes:
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<I", len(val)) + val

    chan = channel.encode() + b"\0" + struct.pack("<IIII", _FLOAT, 0, 1, 1) + b"\0"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = (
        struct.pack("<II", _MAGIC, 2)
        + attr("channels", "chlist", chan)
        + attr("compression", "compression", struct.pack("<B", _ZIP))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    n_blocks = (H + 15) // 16
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * 16
        rows = img[y0 : y0 + 16].tobytes()
        comp = zlib.compress(_do_exr_zip(rows))
        if len(comp) >= len(rows):
            comp = rows
        blocks.append(struct.pack("<iI", y0, len(comp)) + comp)
    table_off = len(header) + 8 * n_blocks
    offsets = []
    pos = table_off
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for b in blocks:
            f.write(b)
