"""KITTI odometry reader with stereo depth by block matching on the device.

Port of `vslam_tpu.io.kitti`. Disparity comes from a block-matching cost
volume: the SAD of the left image against the right image shifted by
d = 0..D-1, box-filtered, then argmin, parabolic sub-pixel refinement, a
uniqueness test and a left-right consistency check; depth = fx * b / disp.
The JAX version builds the volume from D static shifts in a Python loop
that XLA fuses; here it is one (..., D, H, W) tensor (a padded right image
seen as D shifted windows, one abs-diff, one batched separable pass), so a
frame costs about a hundred launches, not D times as many. The matcher takes
leading batch axes: the sequential scan runs it on (S, H, W) pairs with one
``fx`` per sequence.

Directory layout (KITTI odometry):
  <root>/sequences/<seq>/image_0/*.png   left gray
  <root>/sequences/<seq>/image_1/*.png   right gray
  <root>/sequences/<seq>/calib.txt       P0..P3 projection matrices
  <root>/sequences/<seq>/times.txt
  <root>/poses/<seq>.txt                 ground truth (3x4 cam0->world)
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import image as img_ops
from ..core.device import resolve

__all__ = ["KittiDataset", "stereo_depth", "block_matching_disparity"]

_BIG = 1e9  # the cost of a disparity with no right-image support


def block_matching_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    max_disparity: int = 96,
    block: int = 9,
    lr_check: bool = True,
    uniqueness: float = 0.98,
) -> torch.Tensor:
    """Sub-pixel disparity map (..., H, W) of rectified f32 images (..., H,
    W); 0 marks invalid or unmatched pixels. Ties in the cost go to the
    smaller disparity, as `jnp.argmin` gives them."""
    D = int(max_disparity)
    W = left.shape[-1]
    dtype, device = left.dtype, left.device
    big = torch.tensor(_BIG, dtype=dtype, device=device)

    # cost[d, y, x] = box(|L(y, x) - R(y, x - d)|), R zero left of column 0
    padded = torch.nn.functional.pad(right, (D - 1, 0))
    shifted = padded.unfold(-1, W, 1).flip(-2).movedim(-2, -3)  # (..., D, H, W) view
    taps = (1.0 / block,) * block
    cost = img_ops._sep_conv_reflect((left.unsqueeze(-3) - shifted).abs_(), taps, taps)
    dgrid = torch.arange(D, device=device).view(D, 1, 1)
    xx = torch.arange(W, device=device)
    cost.masked_fill_(xx < dgrid, _BIG)

    d_best = torch.argmin(cost, dim=-3, keepdim=True)  # (..., 1, H, W)
    c_best = torch.gather(cost, -3, d_best)
    # parabolic sub-pixel refinement on (c[-1], c[0], c[+1])
    c_m = torch.gather(cost, -3, torch.clamp(d_best - 1, 0, D - 1))
    c_p = torch.gather(cost, -3, torch.clamp(d_best + 1, 0, D - 1))
    denom = c_m - 2 * c_best + c_p
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (c_m - c_p) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    disp = d_best.to(dtype) + torch.clamp(delta, -0.5, 0.5)

    # uniqueness: the best cost beats the runner-up outside +-1 clearly
    # (compared as bools: an int64 |d - d_best| would take two cost volumes each)
    excl = (dgrid >= d_best - 1) & (dgrid <= d_best + 1)
    c_second = torch.where(excl, big, cost).amin(dim=-3, keepdim=True)
    valid = (d_best > 0) & (d_best < D - 1) & (c_best <= uniqueness * c_second) & (c_best < big)

    if lr_check:
        # the right image's costs are the left's shifted per slice:
        # cost_r(x, d) = cost(x + d, d), big where x + d >= W (see the JAX
        # version for why the box filter's border does not break this)
        wide = torch.nn.functional.pad(cost, (0, D - 1), value=_BIG).contiguous()
        st = wide.stride()
        cost_r = wide.as_strided(cost.shape, st[:-3] + (st[-3] + 1,) + st[-2:])
        d_right = torch.argmin(cost_r, dim=-3, keepdim=True)
        x_r = torch.clamp(xx - d_best, 0, W - 1)
        d_r_at = torch.gather(d_right, -1, x_r)
        valid = valid & ((d_r_at - d_best).abs() <= 1)

    return torch.where(valid, disp, torch.zeros_like(disp)).squeeze(-3)


def stereo_depth(left: torch.Tensor, right: torch.Tensor, fx, baseline: float, **kw) -> torch.Tensor:
    """Metric depth (..., H, W) from a rectified pair; 0 where no disparity
    above half a pixel. ``fx`` is a number or a tensor of the images' batch
    shape (one focal length per pair)."""
    disp = block_matching_disparity(left, right, **kw)
    if torch.is_tensor(fx):
        fxb = (fx.to(disp.dtype) * baseline).reshape(fx.shape + (1, 1))
    else:
        fxb = torch.tensor(float(fx) * float(baseline), dtype=disp.dtype, device=disp.device)
    # a true division, as the JAX version's (python / tensor multiplies by a reciprocal)
    depth = torch.div(fxb, torch.clamp(disp, min=0.5))
    return torch.where(disp > 0.5, depth, torch.zeros_like(depth))


def _load_png(path: str) -> np.ndarray:
    """An 8-bit gray PNG as f32 in [0, 255]: the native decoder where it
    builds, else PIL."""
    from .tum import _use_native

    if _use_native():
        from .native_loader import decode_png

        return decode_png(path)
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32)


def _load_png_u8(path: str) -> np.ndarray:
    return _load_png(path).astype(np.uint8)


class KittiDataset:
    """Iterates (t_ns, gray_left f32, depth f32 [m]) over a KITTI odometry
    sequence; depth from stereo block matching on ``device`` (CUDA unless
    named), handed back as numpy."""

    def __init__(
        self,
        root: str,
        sequence: str = "00",
        max_frames: Optional[int] = None,
        max_disparity: int = 96,
        device=None,
    ):
        self.root = root
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.device = resolve(device)
        left_dir = os.path.join(self.seq_dir, "image_0")
        self.left_files = sorted(
            os.path.join(left_dir, f) for f in os.listdir(left_dir) if f.endswith(".png")
        )
        right_dir = os.path.join(self.seq_dir, "image_1")
        self.right_files = sorted(
            os.path.join(right_dir, f) for f in os.listdir(right_dir) if f.endswith(".png")
        )
        if max_frames:
            self.left_files = self.left_files[:max_frames]
            self.right_files = self.right_files[:max_frames]
        self.times = self._load_times(os.path.join(self.seq_dir, "times.txt"))
        self.fx, self.fy, self.cx, self.cy, self.baseline = self._load_calib(
            os.path.join(self.seq_dir, "calib.txt")
        )
        self.max_disparity = max_disparity
        gt_path = os.path.join(root, "poses", f"{sequence}.txt")
        self.groundtruth = self._load_poses(gt_path) if os.path.exists(gt_path) else {}

    @staticmethod
    def _load_times(path: str):
        with open(path) as f:
            return [float(line.strip()) for line in f if line.strip()]

    @staticmethod
    def _load_calib(path: str):
        P = {}
        with open(path) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    P[k.strip()] = np.array(v.split(), dtype=np.float64).reshape(3, 4)
        p0, p1 = P["P0"], P["P1"]
        fx, fy, cx, cy = p0[0, 0], p0[1, 1], p0[0, 2], p0[1, 2]
        baseline = -p1[0, 3] / p1[0, 0]
        return float(fx), float(fy), float(cx), float(cy), float(baseline)

    def _load_poses(self, path: str) -> Dict[float, np.ndarray]:
        out = {}
        with open(path) as f:
            rows = [np.array(line.split(), dtype=np.float64).reshape(3, 4) for line in f if line.strip()]
        for i, m in enumerate(rows):
            if i >= len(self.times):
                break
            T = np.eye(4)
            T[:3, :4] = m  # cam0 -> world (TUM-compatible cam->world)
            out[self.times[i]] = T
        return out

    def intrinsics(self):
        return self.fx, self.fy, self.cx, self.cy

    def __len__(self) -> int:
        return len(self.left_files)

    def _stamp_ns(self, i: int) -> int:
        t = self.times[i] if i < len(self.times) else i * 0.1
        return int(t * 1e9)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        for i, (lf, rf) in enumerate(zip(self.left_files, self.right_files)):
            left = _load_png(lf)
            right = _load_png(rf)
            depth = stereo_depth(
                torch.from_numpy(left).to(self.device),
                torch.from_numpy(right).to(self.device),
                self.fx,
                self.baseline,
                max_disparity=self.max_disparity,
            )
            yield self._stamp_ns(i), left, depth.cpu().numpy()

    def iter_stereo(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Raw (t_ns, left u8, right u8) stream for the sequential scan,
        which block-matches depth on the device inside its step
        (`SequentialConfig.stereo_baseline`)."""
        for i, (lf, rf) in enumerate(zip(self.left_files, self.right_files)):
            yield self._stamp_ns(i), _load_png_u8(lf), _load_png_u8(rf)
