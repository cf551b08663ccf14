"""Where a suite sequence's poses part from its single-sequence run, on one
NVIDIA GPU:

    python3 scripts/suite_parity.py [--steps N] [--traced T]

The streams are `chip_smoke.py`'s phase 21 (S = 4 sequences of 32 frames
at 480x640, the odometry profile). From the same first frames, four runs of
the port's sequential step advance sequence 0:

- ``single``: S = 1 with scalar camera leaves, as `SequentialOdometry`;
- ``single(1,)``: S = 1 with camera leaves (1,), as a suite of one;
- ``suite``: S = 4, the four sequences, leaves (4,), as
  `MultiSequenceOdometry`;
- ``suite x4``: S = 4, sequence 0 four times.

For the first T steps every ATen op (and every launch of the whole-level
kernel) is recorded with its outputs. Pairs of runs are matched op by op
(by name, in order), and sequence 0's slice of each output is compared bit
for bit (outputs with no axis, which reduce over the whole batch, are not). Per pair and step the script prints the ops compared, how many
differ, and the first few that differ, each with the largest difference
and the port's source line that called it; the first differing op whose
inputs agreed is where the two runs part. A second ``suite`` run against
the first shows whether the device repeats itself. After N steps it prints
each pair's per-frame pose gap (SE(3) log) beside the card's name and
power limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import difflib
import pathlib
import subprocess
import sys
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _flat_tensors(out):
    import torch
    from torch.utils._pytree import tree_flatten

    return [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]


def _where():
    """The innermost frames of the port on the stack, as file:line."""
    frames = [f for f in traceback.extract_stack() if "vslam_tpu_torch" in f.filename]
    return " < ".join(f"{f.filename[f.filename.rfind('vslam_tpu_torch'):]}:{f.lineno}" for f in frames[::-1][:3])


def _recorder():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

    class Recorder(TorchDispatchMode):
        """Every op's name, cloned outputs and caller, in order."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def record(self, name, outs):
            with _disable_current_modes():
                self.ops.append((name, [o.detach().clone() for o in outs], _where()))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if "empty" not in name:  # allocations hold no values yet
                self.ops.append((name, [o.detach().clone() for o in _flat_tensors(out)], _where()))
            return out

    return Recorder


def _slot0(t, S, rows):
    """Sequence 0's part of an output of an S-sequence run whose S = 1
    counterpart has ``rows`` leading rows (1, or F frames of one pair)."""
    if S > 1 and t.dim() > 0 and t.shape[0] == S * rows:
        return t[:rows]
    return t


def _differ(a, b):
    """None where a and b are bit-equal, else their largest difference."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return "shape"
    if a.dtype.is_floating_point:
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        if bool(same.all()):
            return None
        return float((a.double() - b.double()).abs()[~same].nan_to_num(float("inf")).max())
    return None if torch.equal(a, b) else float((a.long() - b.long()).abs().max())


def _compare(ref, got, S_ref, S_got, label, step, show=6):
    names_r, names_g = [n for n, _, _ in ref], [n for n, _, _ in got]
    sm = difflib.SequenceMatcher(a=names_r, b=names_g, autojunk=False)
    compared, differing, first = 0, 0, []
    for block in sm.get_matching_blocks():
        for k in range(block.size):
            (_, outs_r, _), (name, outs_g, where) = ref[block.a + k], got[block.b + k]
            for i, (r, g) in enumerate(zip(outs_r, outs_g)):
                if r.dim() == 0 and S_ref != S_got:
                    continue  # a reduction over the whole batch
                if r.dim() and r.shape[0] % S_ref:
                    continue
                rows = r.shape[0] // S_ref if r.dim() else 1
                d = _differ(_slot0(r, S_ref, rows), _slot0(g, S_got, rows))
                compared += 1
                if d is not None:
                    differing += 1
                    if len(first) < show:
                        first.append(f"op {block.b + k} {name} output {i} {tuple(g.shape)}: {d} at {where}")
    print(f"{label}, step {step}: {len(ref)} / {len(got)} ops, {sum(b.size for b in sm.get_matching_blocks())} "
          f"matched, {compared} outputs compared, {differing} differ in sequence 0", flush=True)
    for line in first:
        print(f"    {line}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=31)
    ap.add_argument("--traced", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("suite_parity.py needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from vslam_tpu_torch.alignment import fused_solve
    from vslam_tpu_torch.core import lie_np
    from vslam_tpu_torch.core.camera import Camera
    from vslam_tpu_torch.odometry import sequential
    from vslam_tpu_torch.parallel.sequences import init_states, stack_cameras

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _, streams = cs._suite_streams()
    cfg = cs._odometry_cfg("odometry")
    cam = Camera.create(cs.FX, cs.FX, (cs.W - 1) / 2, (cs.H - 1) / 2)
    dev = cam.fx.device
    up = sequential._upload

    def images(seqs, k):
        return (up(np.stack([s[k][1] for s in seqs]), dev), up(np.stack([s[k][2] for s in seqs]), dev))

    runs = {
        "single": ([streams[0]], sequential._device_camera(cam, dev)),
        "single(1,)": ([streams[0]], stack_cameras([cam])),
        "suite": (streams, stack_cameras([cam] * 4)),
        "suite again": (streams, stack_cameras([cam] * 4)),
        "suite x4": ([streams[0]] * 4, stack_cameras([cam] * 4)),
    }
    pairs = [("single", "single(1,)"), ("single(1,)", "suite"), ("suite", "suite again"), ("suite", "suite x4")]
    states = {name: init_states(*images(seqs, 0), c, cfg) for name, (seqs, c) in runs.items()}
    poses = {name: [] for name in runs}
    Recorder = _recorder()
    dt = cs.DT_NS / 1e9
    for k in range(1, args.steps + 1):
        logs = {}
        for name, (seqs, c) in runs.items():
            inten, depth = images(seqs, k)
            dts = torch.full((len(seqs),), dt, device=dev)
            if k <= args.traced:
                rec = Recorder()
                fn = fused_solve.solve_level_fused

                def tapped(*a, **kw):
                    out = fn(*a, **kw)
                    rec.record("kernel solve_level_fused", _flat_tensors(out))
                    return out

                fused_solve.solve_level_fused = tapped
                try:
                    with rec:
                        states[name], out = sequential._step(states[name], inten, depth, dts, None, c, cfg)
                    torch.cuda.synchronize()
                finally:
                    fused_solve.solve_level_fused = fn
                logs[name] = (len(seqs), rec.ops)
            else:
                states[name], out = sequential._step(states[name], inten, depth, dts, None, c, cfg)
            pose = out[0]
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = pose.R[0].double().cpu().numpy(), pose.t[0].double().cpu().numpy()
            poses[name].append(T)
        for a, b in pairs if logs else ():
            _compare(logs[a][1], logs[b][1], logs[a][0], logs[b][0], f"{a} against {b}", k)
        del logs
    for a, b in pairs:
        gaps = [float(np.linalg.norm(lie_np.log(lie_np.relative(p, q)))) for p, q in zip(poses[a], poses[b])]
        first = next((i + 1 for i, (p, q) in enumerate(zip(poses[a], poses[b])) if not np.array_equal(p, q)), None)
        print(f"{a} against {b}: sequence 0's per-frame pose gap over {args.steps} steps max {max(gaps):.3e} "
              f"(at step {int(np.argmax(gaps)) + 1}), first pose not bit-equal at step {first}; steps 1-8 "
              f"{', '.join(f'{g:.1e}' for g in gaps[:8])} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
