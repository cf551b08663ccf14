"""The port's OpenEXR codec (`vslam_tpu_torch.io.exr`) against the JAX
package's, bit for bit.

Neither package's `write_exr` writes HALF or UINT channels or the NONE and
ZIPS compressions (it writes what the reference's depth files are: one
FLOAT channel, ZIP), so the files of every channel type x compression come
from a scanline writer here that follows the file-format specification
and takes the zip pre-filter of the package named as writer; the other
package reads them. Decoded arrays are compared by their bits; `write_exr`
of both packages writes the same bytes.
"""

import struct
import zlib

import numpy as np
import pytest

from vslam_tpu.io import exr as jexr
from vslam_tpu_torch.io import exr

TYPES = {"UINT": (0, np.dtype("<u4")), "HALF": (1, np.dtype("<f2")), "FLOAT": (2, np.dtype("<f4"))}
COMPRESSIONS = {"NONE": (0, 1), "ZIPS": (2, 1), "ZIP": (3, 16)}


def _write(path, planes, ptype, comp, prefilter):
    """A single-part scanline file of the named channels (alphabetical, as
    the format stores them), all of one pixel type."""
    code, dt = TYPES[ptype]
    comp_code, lines = COMPRESSIONS[comp]
    names = sorted(planes)
    H, W = planes[names[0]].shape

    def attr(name, typ, val):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<I", len(val)) + val

    chans = b"".join(n.encode() + b"\0" + struct.pack("<IIII", code, 0, 1, 1) for n in names) + b"\0"
    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = (struct.pack("<II", 0x01312F76, 2) + attr("channels", "chlist", chans)
              + attr("compression", "compression", struct.pack("<B", comp_code))
              + attr("dataWindow", "box2i", box) + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0") + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\0")
    blocks = []
    for y0 in range(0, H, lines):
        raw = b"".join(planes[n][y].astype(dt).tobytes() for y in range(y0, min(y0 + lines, H)) for n in names)
        data = raw
        if comp_code:
            packed = zlib.compress(prefilter(raw))
            data = packed if len(packed) < len(raw) else raw
        blocks.append(struct.pack("<iI", y0, len(data)) + data)
    offsets, pos = [], len(header) + 8 * len(blocks)
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(blocks)}Q", *offsets) + b"".join(blocks))


def _planes(ptype, H=37, W=23, seed=0):
    rng = np.random.default_rng(seed)
    smooth = np.add.outer(np.linspace(0, 3, H), np.linspace(0, 2, W))
    if ptype == "UINT":
        return {"Y": (smooth * 1000).astype(np.uint32),
                "Z": rng.integers(0, 2**32, (H, W), dtype=np.uint64).astype(np.uint32)}
    noisy = smooth + rng.normal(0, 1e-3, (H, W))
    noisy[3, 4], noisy[5, 6] = np.inf, np.nan
    return {"Y": smooth.astype(np.float32), "Z": noisy.astype(np.float32)}


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("ptype", list(TYPES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_across_packages(tmp_path, writer, ptype, comp):
    """Both packages decode the same file to the same bits: two channels
    (H, W, 2) and each channel alone (H, W)."""
    planes = _planes(ptype)
    prefilter = (jexr if writer == "jax" else exr)._do_exr_zip
    two, one = str(tmp_path / "two.exr"), str(tmp_path / "one.exr")
    _write(two, planes, ptype, comp, prefilter)
    _write(one, {"Y": planes["Y"]}, ptype, comp, prefilter)
    got, want = exr.read_exr(two), jexr.read_exr(two)
    assert got.shape == (37, 23, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got[..., 0]), _bits(planes["Y"].astype(TYPES[ptype][1]).astype(np.float32)))
    np.testing.assert_array_equal(_bits(exr.read_exr(one)), _bits(jexr.read_exr(one)))
    assert exr.read_exr(one).shape == (37, 23)


@pytest.mark.parametrize("shape,kind", [((50, 33), "smooth"), ((16, 8), "smooth"), ((21, 19), "noise")],
                         ids=["50x33", "16x8", "incompressible"])
def test_write_exr_bytes_equal_the_jax_packages(tmp_path, shape, kind):
    """`write_exr` writes the JAX package's bytes (ZIP blocks of 16 lines,
    raw where zlib does not shrink a block), and each package reads the
    other's file back exactly."""
    rng = np.random.default_rng(2)
    if kind == "noise":
        img = rng.uniform(-1e30, 1e30, shape).astype(np.float32)
    else:
        img = (np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 0.01).astype(np.float32)
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    exr.write_exr(a, img, channel="Z")
    jexr.write_exr(b, img, channel="Z")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(_bits(jexr.read_exr(a)), _bits(img))
    np.testing.assert_array_equal(_bits(exr.read_exr(b)), _bits(img))


def test_unsupported_files_are_refused(tmp_path):
    path = str(tmp_path / "x.exr")
    with open(path, "wb") as f:
        f.write(b"not an exr at all")
    with pytest.raises(ValueError, match="not an EXR"):
        exr.read_exr(path)
    with pytest.raises(ValueError, match="single-channel"):
        exr.write_exr(path, np.zeros((2, 2, 2), np.float32))
