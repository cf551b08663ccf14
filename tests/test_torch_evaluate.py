"""The port's CLI (`python -m vslam_tpu_torch.eval.evaluate`) against the
JAX package's on the same files.

* A mini TUM dataset of 8 frames at 96x128 (PNG files, as
  `tests/test_cli_e2e.py` builds it): `odometry --device cpu` on the host
  loop and with `--fused` (the sequential scan), each trajectory file within
  1e-3 of the JAX CLI's, frame by frame. The fused comparison keeps the
  reference's dense gather profile (`--parity`): the JAX `fused_gn` Pallas
  kernel in interpret mode costs seconds a call. The production profile
  (`fused_gn`, the whole-level kernel's plain version on the CPU) runs
  through `reproduce`.
* `evaluate`, `ate` and `rpe` print the same numbers as JAX's on the same
  files, to 1e-9.
* `synthetic --frames 8 --device cpu` tracks (ATE < 0.01 m).
* `reproduce` exits 0, 1 and 2 as the JAX CLI does
  (`tests/test_cli_e2e.py:373-412`).
* Each option that waits for an unported module raises NotImplementedError
  naming it.
"""

import json
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from vslam_tpu.eval.evaluate import main as jax_main
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.eval.evaluate import main as port_main
from vslam_tpu_torch.io import synthetic, tum

H, W, FX = 96, 128, 110.0
N_FRAMES = 8
INTRINSICS = f"{FX},{FX},{(W - 1) / 2},{(H - 1) / 2}"


@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_tum")
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.smooth_trajectory(N_FRAMES, trans_amp=0.06, rot_amp=0.02, seed=11)
    p0i = lie_np.inv(poses[0])
    poses = [p @ p0i for p in poses]
    rgb_lines, depth_lines, gt = [], [], {}
    for i, p in enumerate(poses):
        t = 1000.0 + i / 30.0
        intensity, depth = synthetic.render(K, p, (H, W))
        Image.fromarray(np.clip(intensity, 0, 255).astype(np.uint8)).save(root / "rgb" / f"{t:.6f}.png")
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(root / "depth" / f"{t:.6f}.png")
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t:.6f} depth/{t:.6f}.png")
        gt[t] = lie_np.inv(p)  # TUM files are cam->world
    (root / "rgb.txt").write_text("# ts file\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("# ts file\n" + "\n".join(depth_lines) + "\n")
    tum.write_trajectory(str(root / "groundtruth.txt"), gt)
    return root


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def trajectories(mini_dataset, tmp_path_factory):
    """Both CLIs' `odometry` on the mini dataset, host loop and fused scan:
    {mode: (port trajectory path, JAX trajectory path)}."""
    out_dir = tmp_path_factory.mktemp("odometry")
    runs = {}
    for mode, flags in (("host", []), ("fused", ["--fused", "--parity", "--chunk", "4"])):
        paths = {}
        for pkg, main, extra in (("port", port_main, ["--device", "cpu"]), ("jax", jax_main, [])):
            paths[pkg] = str(out_dir / f"{pkg}_{mode}.txt")
            rc = main(["odometry", "--dataset", str(mini_dataset), "--out", paths[pkg], "--intrinsics", INTRINSICS,
                       "--no-eval", *flags, *extra])
            assert rc == 0
        runs[mode] = (paths["port"], paths["jax"])
    return runs


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_odometry_trajectory_files_match_jax(mini_dataset, trajectories, mode):
    port_path, jax_path = trajectories[mode]
    got, want = tum.read_trajectory(port_path), tum.read_trajectory(jax_path)
    assert sorted(got) == sorted(want) and len(got) == N_FRAMES
    for t in want:
        assert np.linalg.norm(lie_np.log(lie_np.relative(got[t], want[t]))) < 1e-3, (mode, t)
    meta = json.loads(open(port_path + ".meta.json").read())
    assert meta["frames"] == N_FRAMES and meta["config"]["sampler"] == "gather"
    # the 36 covariance columns on every row, as the JAX writer appends them
    rows = [line.split() for line in open(port_path) if not line.startswith("#")]
    assert {len(r) for r in rows} == {len(r) for r in (line.split() for line in open(jax_path)
                                                       if not line.startswith("#"))}


def _metric_numbers(text: str):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


@pytest.mark.parametrize(
    "argv",
    [
        ["evaluate", "--fixed-delta", "0.1"],
        ["ate", "--verbose"],
        ["ate"],
        ["rpe", "--fixed-delta", "--delta", "3", "--delta-unit", "f", "--verbose"],
        ["rpe"],
    ],
    ids=["evaluate", "ate-verbose", "ate", "rpe-fixed-frames-verbose", "rpe"],
)
def test_metric_subcommands_print_what_jax_prints(mini_dataset, trajectories, tmp_path, capsys, argv):
    """The same numbers from the same files: the JAX CLI's trajectory
    against the ground truth, each CLI writing its summaries into a
    directory of its own."""
    printed = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        algo = tmp_path / pkg / "traj.txt"
        algo.parent.mkdir()
        shutil.copy(trajectories["host"][1], algo)
        rc = main([argv[0], "--gt", str(mini_dataset / "groundtruth.txt"), "--algo", str(algo), *argv[1:]])
        assert rc == 0
        printed[pkg] = capsys.readouterr().out
        if argv[0] == "evaluate":
            printed[pkg] += (algo.parent / "ate_summary.txt").read_text()
            printed[pkg] += (algo.parent / "rpe_summary.txt").read_text()
    got, want = _metric_numbers(printed["port"]), _metric_numbers(printed["jax"])
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert re.sub(r"[-\d.e]+", "#", printed["port"]) == re.sub(r"[-\d.e]+", "#", printed["jax"])


def test_synthetic_tracks_on_the_cpu(capsys):
    assert port_main(["synthetic", "--frames", "8", "--device", "cpu"]) == 0
    (res,) = _json_lines(capsys)
    assert res["frames"] == 8 and res["landmarks"] == 0
    assert res["ate_rmse_m"] < 0.01, res


def test_reproduce_exit_codes(mini_dataset, tmp_path, capsys):
    """0 when both budgets hold, 1 on a regression, 2 without ground truth;
    the replay takes the production profile (`fused_gn`) by default."""
    out = str(tmp_path / "repro.txt")
    base = ["reproduce", "--dataset", str(mini_dataset), "--out", out, "--intrinsics", INTRINSICS,
            "--chunk", "4", "--device", "cpu"]
    assert port_main(base) == 0
    res = _json_lines(capsys)[-1]
    assert res["pass"] is True and res["ate_rmse_m"] < 0.02, res
    assert res["rpe_budget_m"] == 0.036 and res["ate_budget_m"] == 0.21
    assert json.loads(open(out + ".meta.json").read())["config"]["sampler"] == "fused_gn"

    assert port_main(base + ["--ate-budget", "1e-9"]) == 1
    assert _json_lines(capsys)[-1]["pass"] is False

    broken = tmp_path / "no_gt"
    shutil.copytree(mini_dataset, broken)
    (broken / "groundtruth.txt").unlink()
    base[2] = str(broken)
    assert port_main(base) == 2
    capsys.readouterr()


@pytest.mark.parametrize(
    "argv,module",
    [
        (["odometry", "--dataset", "d", "--format", "kitti"], "io/kitti.py"),
        (["odometry", "--dataset", "d", "--mapping"], "odometry/sequential_mapping.py"),
        (["odometry", "--dataset", "d", "--dataset", "e", "--fused"], "parallel/sequences.py"),
        (["odometry", "--dataset", "d", "--live-viz", "0"], "viz/live.py"),
        (["synthetic", "--mapping"], "odometry/sequential_mapping.py"),
        (["synthetic", "--live-viz", "0"], "viz/live.py"),
    ],
    ids=["kitti", "mapping", "suite", "live-viz", "synthetic-mapping", "synthetic-live-viz"],
)
def test_unported_options_raise_naming_their_module(argv, module):
    with pytest.raises(NotImplementedError, match=re.escape(module)):
        port_main([*argv, "--device", "cpu"])
