"""Dense image operations on torch tensors.

Port of `vslam_tpu.core.image`: sampling, cv::pyrDown, the 3x3 Gaussian
blur, Sobel and Scharr derivatives, the masked 3x3 median on depth, and the
reference's own conv2d, gradients and resize (`algorithm.{h,cpp}`). Every
function takes images of shape (..., H, W) and maps over the leading axes,
on the image's device. The stencils are shifted-slice adds, as in the JAX
version, never `conv2d`: cuDNN (and its TF32 default) never sees them; the
JAX function's `lax.conv` of a general kernel becomes one shifted-slice
multiply-add a tap here, so its sums run in another order.
"""

from __future__ import annotations

import torch

__all__ = [
    "bilinear_sample",
    "nearest_sample",
    "conv2d_reflect",
    "conv2d_norm_interior",
    "gaussian_blur_3x3",
    "sobel_x",
    "sobel_y",
    "scharr_x",
    "scharr_y",
    "grad_x",
    "grad_y",
    "pyr_down",
    "resize_bilinear",
    "median_blur_3x3_masked",
    "masked_median",
]


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _gather2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Clipped 2-D gather. ``img: (*L, H, W)``; integer index arrays of shape
    (*L, ...): each image is read at its own indices."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    iy = torch.clamp(iy, 0, H - 1)
    ix = torch.clamp(ix, 0, W - 1)
    flat = img.reshape(*lead, H * W)
    idx = (iy * W + ix).reshape(*lead, -1)
    return torch.gather(flat, -1, idx).reshape(iy.shape)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation at continuous coords (x = col, y = row)
    (reference `algorithm.h:36-82`). Out-of-range coords are clamped;
    callers mask validity."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(img.dtype)
    fy = (y - y0).to(img.dtype)
    ix0 = x0.long()
    iy0 = y0.long()
    q11 = _gather2d(img, iy0, ix0)
    q21 = _gather2d(img, iy0, ix0 + 1)
    q12 = _gather2d(img, iy0 + 1, ix0)
    q22 = _gather2d(img, iy0 + 1, ix0 + 1)
    top = q11 * (1.0 - fx) + q21 * fx
    bot = q12 * (1.0 - fx) + q22 * fx
    return top * (1.0 - fy) + bot * fy


def nearest_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest lookup, floor(x + 0.5) (the reference's
    `std::round` on non-negative coords, `InverseCompositional.cpp:119-120`)."""
    ix = torch.floor(x + 0.5).long()
    iy = torch.floor(y + 0.5).long()
    return _gather2d(img, iy, ix)


# ---------------------------------------------------------------------------
# Stencils
# ---------------------------------------------------------------------------

_GAUSS3 = (0.25, 0.5, 0.25)
_SOBEL_D = (-1.0, 0.0, 1.0)
_SOBEL_S = (1.0, 2.0, 1.0)
_SCHARR_D = (-1.0, 0.0, 1.0)
_SCHARR_S = (3.0, 10.0, 3.0)
_PYR5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _pad_reflect(img: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """Reflect-101 padding (OpenCV BORDER_DEFAULT, numpy "reflect")."""
    n = img.shape[dim]
    left = img.narrow(dim, 1, p).flip(dim)
    right = img.narrow(dim, n - 1 - p, p).flip(dim)
    return torch.cat([left, img, right], dim=dim)


def _sep_pass(img: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """One axis of a separable correlation as shifted-slice adds, summed in
    place into a fresh tensor (so a large input, such as a stereo cost
    volume, holds one partial sum, not two); the input is already padded by
    len(taps)//2 along ``dim``."""
    n = img.shape[dim] - (len(taps) - 1)
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        sl = img.narrow(dim, i, n)
        if out is None:
            out = sl.clone() if t == 1.0 else t * sl
        else:
            out += sl if t == 1.0 else t * sl
    return out


def _sep_conv_reflect(img: torch.Tensor, ky, kx) -> torch.Tensor:
    # rebinding ``img`` frees each stage as the next is made: a temporary
    # input (a stereo cost volume) is gone once padded, the padded copy once
    # the rows are summed
    img = _pad_reflect(_pad_reflect(img, len(ky) // 2, -2), len(kx) // 2, -1)
    img = _sep_pass(img, ky, -2)
    return _sep_pass(img, kx, -1)


def gaussian_blur_3x3(img: torch.Tensor) -> torch.Tensor:
    """cv::GaussianBlur(Size(3,3), sigma=0) == separable [1,2,1]/4."""
    return _sep_conv_reflect(img, _GAUSS3, _GAUSS3)


def sobel_x(img: torch.Tensor) -> torch.Tensor:
    """cv::Sobel(dx=1, ksize=3), reflect-101 (`Frame.cpp:215-232`)."""
    return _sep_conv_reflect(img, _SOBEL_S, _SOBEL_D)


def sobel_y(img: torch.Tensor) -> torch.Tensor:
    return _sep_conv_reflect(img, _SOBEL_D, _SOBEL_S)


def scharr_x(img: torch.Tensor) -> torch.Tensor:
    return _sep_conv_reflect(img, _SCHARR_S, _SCHARR_D)


def scharr_y(img: torch.Tensor) -> torch.Tensor:
    return _sep_conv_reflect(img, _SCHARR_D, _SCHARR_S)


def _conv2d_valid(img: torch.Tensor, kernel) -> torch.Tensor:
    """2-D valid correlation with a (kh, kw) kernel, in f32 and cast back to
    the image's dtype (as the JAX function's `lax.conv`), one shifted-slice
    multiply-add a tap in row-major order."""
    k = torch.as_tensor(kernel, dtype=torch.float32, device=img.device)
    kh, kw = k.shape
    H, W = img.shape[-2:]
    x = img.to(torch.float32)
    out = None
    for i in range(kh):
        for j in range(kw):
            term = x[..., i : i + H - kh + 1, j : j + W - kw + 1] * k[i, j]
            out = term if out is None else out + term
    return out.to(img.dtype)


def conv2d_reflect(img: torch.Tensor, kernel) -> torch.Tensor:
    """Correlate with reflect-101 border (OpenCV BORDER_DEFAULT)."""
    kh, kw = torch.as_tensor(kernel).shape
    return _conv2d_valid(_pad_reflect(_pad_reflect(img, kh // 2, -2), kw // 2, -1), kernel)


def conv2d_norm_interior(img: torch.Tensor, kernel) -> torch.Tensor:
    """Reference `algorithm.cpp:122-149` conv2d: interior pixels only (the
    border stays 0), the response normalized by sum(|kernel|)."""
    k = torch.as_tensor(kernel, device=img.device)
    kh, kw = k.shape
    interior = _conv2d_valid(img, k) / k.abs().sum().to(img.dtype)
    return torch.nn.functional.pad(interior, (kw // 2, kw // 2, kh // 2, kh // 2))


_SCHARR_X = ((-3.0, 0.0, 3.0), (-10.0, 0.0, 10.0), (-3.0, 0.0, 3.0))
_SCHARR_Y = ((-3.0, -10.0, -3.0), (0.0, 0.0, 0.0), (3.0, 10.0, 3.0))


def grad_x(img: torch.Tensor) -> torch.Tensor:
    """Reference `algorithm.cpp:72-75` gradX: the Scharr response normalized
    by sum(|kernel|) = 32, border zero, truncated toward zero (cast<int>)."""
    return torch.trunc(conv2d_norm_interior(img, torch.tensor(_SCHARR_X, dtype=img.dtype)))


def grad_y(img: torch.Tensor) -> torch.Tensor:
    return torch.trunc(conv2d_norm_interior(img, torch.tensor(_SCHARR_Y, dtype=img.dtype)))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5-tap Gaussian [1,4,6,4,1]/16 (separable, reflect-101),
    then decimation by 2; output ceil(n/2) per axis. The vertical pass runs
    on the decimated rows only."""
    padded = _pad_reflect(_pad_reflect(img, 2, -2), 2, -1)
    rows = _sep_pass(padded, _PYR5, -2)[..., ::2, :]
    return _sep_pass(rows, _PYR5, -1)[..., ::2]


def resize_bilinear(img: torch.Tensor, s: float) -> torch.Tensor:
    """Reference `algorithm.h:83-101` resize: output (floor(H*s), floor(W*s)),
    each output pixel sampled at (j/s, i/s), corner-aligned; an integer
    stride 1/s is a strided slice."""
    if s == 1.0:
        return img
    H, W = img.shape[-2:]
    oh, ow = int(H * s), int(W * s)
    inv = 1.0 / s
    if inv == int(inv):
        k = int(inv)
        return img[..., : k * oh : k, : k * ow : k]
    lead = img.shape[:-2]
    ys = (torch.arange(oh, dtype=torch.float32, device=img.device) * inv)[:, None].expand(*lead, oh, ow)
    xs = (torch.arange(ow, dtype=torch.float32, device=img.device) * inv)[None, :].expand(*lead, oh, ow)
    return bilinear_sample(img, xs, ys)


# ---------------------------------------------------------------------------
# Median
# ---------------------------------------------------------------------------

# 9-element sorting network (25 compare-exchanges), as in vslam_tpu
_NET9 = [(0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
         (6, 7), (0, 3), (3, 6), (0, 3), (1, 4), (4, 7), (1, 4), (2, 5),
         (5, 8), (2, 5), (1, 3), (5, 7), (2, 6), (4, 6), (2, 4), (2, 3),
         (5, 6)]


def _pad_const(x: torch.Tensor, value) -> torch.Tensor:
    """Pad the last two axes by one with a constant."""
    out = torch.full(
        (*x.shape[:-2], x.shape[-2] + 2, x.shape[-1] + 2), value, dtype=x.dtype, device=x.device
    )
    out[..., 1:-1, 1:-1] = x
    return out


def median_blur_3x3_masked(img: torch.Tensor, invalid: torch.Tensor) -> torch.Tensor:
    """3x3 median ignoring masked-out pixels; border rows/cols output 0
    (reference `algorithm.h:156-184`). The median of n valid values is the
    standard one: the mean of ranks (n-1)//2 and n//2."""
    H, W = img.shape[-2:]
    big = torch.finfo(torch.float32).max
    vals = torch.where(invalid, torch.full_like(img, big), img)
    vp = _pad_const(vals, big)
    mp = _pad_const(~invalid, False)
    s = []
    n = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    for dy in range(3):
        for dx in range(3):
            s.append(vp[..., dy : dy + H, dx : dx + W])
            n = n + mp[..., dy : dy + H, dx : dx + W]
    for a, b in _NET9:
        s[a], s[b] = torch.minimum(s[a], s[b]), torch.maximum(s[a], s[b])

    def select(idx):
        out = torch.zeros_like(s[0])
        for k in range(9):
            out = torch.where(idx == k, s[k], out)
        return out

    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (select(lo) + select(hi))
    med = torch.where(n > 0, med, torch.zeros_like(med))
    out = torch.zeros_like(med)
    out[..., 1:-1, 1:-1] = med[..., 1:-1, 1:-1]
    return out


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values`` where ``mask`` is True, over the last axis
    (leading axes are independent rows; `vslam_tpu.core.image.masked_median`
    is the one-row case). Sort-based: invalid entries are pushed to +inf and
    the two central ranks (n-1)//2 and n//2 of the n valid ones averaged;
    0 where a row has no valid entry."""
    s = torch.sort(torch.where(mask, values, torch.full_like(values, float("inf"))), dim=-1).values
    n = mask.sum(-1, keepdim=True)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.div(n, 2, rounding_mode="floor")
    med = 0.5 * (torch.gather(s, -1, lo) + torch.gather(s, -1, hi))
    return torch.where(n > 0, med, torch.zeros_like(med))[..., 0]
