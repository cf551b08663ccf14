"""Seeded synthetic inputs, rendered on the device in plain PyTorch.

The scene is the plane of the port's `io/synthetic.render`, restated here so
that the benchmark renders thousands of frames on the card in a few large
calls: a plane n . X = d in world coordinates carrying a sum of sinusoids,
closed-form per pixel (intersect the pixel ray, evaluate the texture at the
hit). Intensity leaves as uint8 and depth as uint16 counts of the sensor's
step (held as int16 bits, as the port's scan takes it), or, for a stereo
rig, as a second uint8 image seen from the right camera.

Every random number comes from one CPU `torch.Generator` seeded with the
run's seed, so a seed gives the same scenes and motions on any machine and
in any run; only the per-pixel arithmetic runs on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["Rig", "rig", "se3_exp", "smooth_motion", "step_lengths", "render", "sensor_pair", "generator",
           "SuiteInputs", "suite_inputs", "PairInputs", "pair_inputs"]


class Rig(NamedTuple):
    """One camera (or the left camera of a stereo rig) at the sensor's size."""

    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    stereo: bool
    baseline: float  # metres, 0 for RGB-D
    depth_step: float  # metres per depth count, 0 for stereo
    dt_ns: int  # time between frames


def rig(config: dict) -> Rig:
    s = config["sensor"]
    stereo = s["kind"] == "stereo"
    return Rig(int(s["height"]), int(s["width"]), float(s["fx"]), float(s["fy"]), float(s["cx"]),
               float(s["cy"]), stereo, float(s.get("baseline_m", 0.0)),
               0.0 if stereo else float(s["depth_scale_m"]), int(round(1e9 / float(s["rate_hz"]))))


def generator(seed: int) -> torch.Generator:
    """The run's one source of randomness: a CPU generator, any seed from 0
    to 2**64 - 1 (larger ones are folded in)."""
    return torch.Generator().manual_seed(int(seed) % (1 << 64))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twists [translation; rotation] to (..., 4, 4) transforms, f64."""
    xi = xi.double()
    phi = xi[..., 3:]
    th2 = (phi * phi).sum(-1)
    th = th2.clamp(min=1e-24).sqrt()
    small = th2 < 1e-10
    A = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2.clamp(min=1e-24))
    C = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / (th2 * th).clamp(min=1e-36))
    W = _hat(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype).expand_as(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    T = torch.zeros(*xi.shape[:-1], 4, 4, dtype=xi.dtype)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ xi[..., :3, None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def _inv(T: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def step_lengths(T: torch.Tensor):
    """Mean camera-centre travel (m) and mean rotation angle (rad) between
    consecutive frames of (S, F, 4, 4) world->camera poses, each (S,)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    c = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    travel = (c[:, 1:] - c[:, :-1]).norm(dim=-1).mean(1)
    rel = R[:, 1:] @ R[:, :-1].transpose(-1, -2)
    cos = ((rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1.0, 1.0)
    return travel, torch.arccos(cos).mean(1)


def _drive(gen: torch.Generator, sequences: int, t: torch.Tensor, motion: dict) -> torch.Tensor:
    """(sequences, F, 4, 4) world->camera poses of a camera carried forward
    (+z) at ``forward_m_s`` along a heading that turns at a sinusoidal yaw
    rate (about the camera's y axis) of amplitude ``yaw_rate_rad_s``."""
    w = _uniform(gen, (sequences, 1), *motion["yaw_freq"])
    ph = _uniform(gen, (sequences, 1), 0.0, 2 * math.pi)
    tt = t[None, :]
    psi = float(motion["yaw_rate_rad_s"]) / w * (torch.cos(ph) - torch.cos(w * tt + ph))
    # the centre integrates the forward velocity along the heading (fine steps)
    sub = 64
    fine = torch.linspace(0.0, float(t[-1]), (len(t) - 1) * sub + 1, dtype=torch.float64)[None, :]
    psi_f = float(motion["yaw_rate_rad_s"]) / w * (torch.cos(ph) - torch.cos(w * fine + ph))
    v = float(motion["forward_m_s"]) * torch.stack([torch.sin(psi_f), torch.zeros_like(psi_f), torch.cos(psi_f)], -1)
    dtf = float(fine[0, 1] - fine[0, 0]) if fine.shape[1] > 1 else 0.0
    c = torch.cat([torch.zeros(sequences, 1, 3, dtype=torch.float64),
                   torch.cumsum(0.5 * (v[:, 1:] + v[:, :-1]) * dtf, 1)], 1)[:, ::sub]
    C = torch.zeros(sequences, len(t), 4, 4, dtype=torch.float64)  # camera -> world
    C[..., 0, 0] = C[..., 2, 2] = torch.cos(psi)
    C[..., 0, 2], C[..., 2, 0] = torch.sin(psi), -torch.sin(psi)
    C[..., 1, 1] = C[..., 3, 3] = 1.0
    C[..., :3, 3] = c
    return _inv(C)


def smooth_motion(gen: torch.Generator, sequences: int, frames: int, dt: float, motion: dict) -> torch.Tensor:
    """(sequences, frames, 4, 4) world->camera poses, re-based so that frame
    0 is the identity. Each sequence is a sinusoidal twist of its own
    frequencies and phases (the port's `synthetic.smooth_trajectory`):

    - with ``mean_speed_m_s`` and ``mean_rate_rad_s`` the twist's
      translation and rotation are scaled, per sequence, so that its camera
      moves at exactly those mean speeds from frame to frame (a recording's
      published averages);
    - with ``forward_m_s`` the twist is a small shake on top of a drive
      (`_drive`): a vehicle's camera at that speed, turning at a sinusoidal
      yaw rate.
    """
    w_t = _uniform(gen, (sequences, 1, 3), *motion["trans_freq"])
    w_r = _uniform(gen, (sequences, 1, 3), *motion["rot_freq"])
    ph = _uniform(gen, (sequences, 1, 6), 0.0, 2 * math.pi)
    t = torch.arange(frames, dtype=torch.float64) * dt
    rho = motion["trans_amp_m"] * torch.sin(w_t * t[None, :, None] + ph[..., :3])
    phi = motion["rot_amp_rad"] * torch.sin(w_r * t[None, :, None] + ph[..., 3:])
    if "mean_rate_rad_s" in motion:
        for _ in range(3):  # the angle is linear in the twist's scale to rounding after three
            _, rate = step_lengths(se3_exp(torch.cat([torch.zeros_like(phi), phi], -1)))
            phi = phi * (float(motion["mean_rate_rad_s"]) * dt / rate)[:, None, None]
    if "mean_speed_m_s" in motion:  # the centres are linear in the translation's scale
        travel, _ = step_lengths(se3_exp(torch.cat([rho, phi], -1)))
        rho = rho * (float(motion["mean_speed_m_s"]) * dt / travel)[:, None, None]
    T = se3_exp(torch.cat([rho, phi], -1))
    if "forward_m_s" in motion:
        T = T @ _drive(gen, sequences, t, motion)
    return T @ _inv(T[:, :1])


class Textures(NamedTuple):
    freqs: torch.Tensor  # (N, waves, 2) rad / m on the plane
    phases: torch.Tensor  # (N, waves, 2)
    amps: torch.Tensor  # (N, waves) grey levels


def textures(gen: torch.Generator, n: int, scene: dict) -> Textures:
    """One texture a scene: wavelengths drawn in the scene's range, the
    amplitudes scaled to the scene's total (the port's `_texture_params`)."""
    k = int(scene["waves"])
    freqs = 2 * math.pi / _uniform(gen, (n, k, 2), *scene["wavelength_m"])
    phases = _uniform(gen, (n, k, 2), 0.0, 2 * math.pi)
    amps = _uniform(gen, (n, k), 0.3, 1.0)
    amps = amps / amps.sum(-1, keepdim=True) * float(scene["amplitude"])
    return Textures(freqs, phases, amps)


def render(r: Rig, poses: torch.Tensor, tex: Textures, scene: dict, device, with_depth: bool = True):
    """Intensity (N, H, W) f32 in [0, 255] and depth (N, H, W) f32 metres (0
    where the ray misses the plane) of N cameras at world->camera ``poses``
    (N, 4, 4), scene i textured by ``tex``'s row i."""
    T_cw = _inv(poses).to(device, torch.float32)
    n = torch.tensor(scene["normal"], dtype=torch.float64)
    n = (n / n.norm()).to(device, torch.float32)
    ys, xs = torch.meshgrid(torch.arange(r.height, device=device, dtype=torch.float32),
                            torch.arange(r.width, device=device, dtype=torch.float32), indexing="ij")
    rays = torch.stack([(xs - r.cx) / r.fx, (ys - r.cy) / r.fy, torch.ones_like(xs)], -1)  # (H, W, 3)
    rays_w = torch.einsum("hwk,njk->nhwj", rays, T_cw[:, :3, :3])
    o = T_cw[:, :3, 3]
    z = (float(scene["d"]) - o @ n)[:, None, None] / (rays_w @ n)
    valid = torch.isfinite(z) & (z > 0.05)
    z = torch.where(valid, z, torch.zeros_like(z))
    X = o[:, None, None, :] + z[..., None] * rays_w
    del rays_w
    p0 = torch.tensor(scene["origin"], device=device, dtype=torch.float32)
    a = (X - p0) @ torch.tensor(scene["e1"], device=device, dtype=torch.float32)
    b = (X - p0) @ torch.tensor(scene["e2"], device=device, dtype=torch.float32)
    del X
    f = tex.freqs.to(device, torch.float32)
    ph = tex.phases.to(device, torch.float32)
    am = tex.amps.to(device, torch.float32)
    inten = torch.full_like(a, float(scene["base_intensity"]))
    for k in range(f.shape[1]):
        inten += (am[:, k, None, None] * torch.sin(f[:, k, 0, None, None] * a + ph[:, k, 0, None, None])
                  * torch.cos(f[:, k, 1, None, None] * b + ph[:, k, 1, None, None]))
    inten = torch.where(valid, inten.clamp(0.0, 255.0), torch.zeros_like(inten))
    return inten, (z if with_depth else None)


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def _depth_bits(z: torch.Tensor, step: float) -> torch.Tensor:
    """Metres as uint16 counts of ``step``, held as int16 bits."""
    c = torch.round(z / step).clamp(0, 65535).to(torch.int32)
    return torch.where(c >= 32768, c - 65536, c).to(torch.int16)


def sensor_pair(r: Rig, poses: torch.Tensor, tex: Textures, scene: dict, device):
    """What the sensor delivers for N cameras: (uint8 intensity, int16 bits
    of the uint16 depth counts) for RGB-D, (uint8 left, uint8 right) for a
    rectified stereo rig (the right camera ``baseline`` metres along x)."""
    inten, z = render(r, poses, tex, scene, device, with_depth=not r.stereo)
    if not r.stereo:
        return _u8(inten), _depth_bits(z, r.depth_step)
    right = torch.eye(4, dtype=torch.float64).repeat(len(poses), 1, 1)
    right[:, 0, 3] = -r.baseline
    return _u8(inten), _u8(render(r, right @ poses, tex, scene, device, with_depth=False)[0])


class SuiteInputs(NamedTuple):
    """S sequences of F frames in the sensor's dtypes on the device, laid
    out as the scan is fed: frame 0 apart, the rest in chunks. Each image
    is (intensity, second): uint8 intensity and int16 bits of the uint16
    depth counts, or uint8 left and right images."""

    first: tuple  # ((S, H, W), (S, H, W))
    chunks: list  # [((S, K, H, W), (S, K, H, W)), ...] frames 1 .. F-1
    poses: torch.Tensor  # (S, F, 4, 4) f64 world->camera ground truth
    dt_ns: int

    def frame(self, k: int) -> tuple:
        """Frame k of every sequence: ((S, H, W), (S, H, W)) views."""
        if k == 0:
            return self.first
        i = k - 1
        for a, b in self.chunks:
            if i < a.shape[1]:
                return a[:, i], b[:, i]
            i -= a.shape[1]
        raise IndexError(k)


def suite_inputs(config: dict, traffic: dict, seed: int, device, block: int = 64) -> SuiteInputs:
    """The suite mix: ``sequences`` independent sequences of ``frames``
    frames, each with its own plane texture and its own smooth motion,
    rendered straight into the chunks of ``chunk`` frames the scan takes,
    ``block`` sequences at a time."""
    r = rig(config)
    gen = generator(seed)
    S, F, K = int(traffic["sequences"]), int(traffic["frames"]), int(traffic["chunk"])
    tex = textures(gen, S, traffic["scene"])
    poses = smooth_motion(gen, S, F, r.dt_ns / 1e9, traffic["motion"])
    second_dtype = torch.uint8 if r.stereo else torch.int16

    def empty(n):
        return (torch.empty(S, n, r.height, r.width, dtype=torch.uint8, device=device),
                torch.empty(S, n, r.height, r.width, dtype=second_dtype, device=device))

    first = tuple(x[:, 0] for x in empty(1))
    chunks = [empty(min(K, F - a)) for a in range(1, F, K)]
    out = SuiteInputs(first, chunks, poses, r.dt_ns)
    for k in range(F):
        dst = out.frame(k)
        for i in range(0, S, block):
            j = min(i + block, S)
            a, b = sensor_pair(r, poses[i:j, k], Textures(*(x[i:j] for x in tex)), traffic["scene"], device)
            dst[0][i:j] = a
            dst[1][i:j] = b
    return out


class PairInputs(NamedTuple):
    """B frame pairs in the sensor's dtypes on the device: each pair's
    reference seen from the identity, its current frame from exp(xi)."""

    ref: tuple  # (intensity (B, H, W) uint8, depth bits (B, H, W) int16)
    cur: tuple
    xis: torch.Tensor  # (B, 6) f64 true motion, [translation; rotation]


def pair_inputs(config: dict, traffic: dict, seed: int, device, block: int = 128) -> PairInputs:
    """The pair mix (the port's `bench.pair_batch` distribution): one scene
    a pair, translation uniform in +-``trans_m``, rotation in +-``rot_rad``."""
    r = rig(config)
    if r.stereo:
        raise ValueError("the pair mix renders RGB-D pairs")
    gen = generator(seed)
    B = int(traffic["pairs"])
    tex = textures(gen, B, traffic["scene"])
    xis = torch.cat([_uniform(gen, (B, 3), -traffic["trans_m"], traffic["trans_m"]),
                     _uniform(gen, (B, 3), -traffic["rot_rad"], traffic["rot_rad"])], -1)
    out = []
    for poses in (torch.eye(4, dtype=torch.float64).repeat(B, 1, 1), se3_exp(xis)):
        inten = torch.empty(B, r.height, r.width, dtype=torch.uint8, device=device)
        depth = torch.empty(B, r.height, r.width, dtype=torch.int16, device=device)
        for i in range(0, B, block):
            j = min(i + block, B)
            inten[i:j], depth[i:j] = sensor_pair(r, poses[i:j], Textures(*(x[i:j] for x in tex)),
                                                 traffic["scene"], device)
        out.append((inten, depth))
    return PairInputs(out[0], out[1], xis)
