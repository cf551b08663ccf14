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
* `odometry --format kitti` on a mini-KITTI tree of 8 stereo pairs (PNG
  files, `test_torch_kitti.build_mini_kitti`), host loop and `--fused
  --parity`: each trajectory file within 1e-3 of the JAX CLI's per pose
  (the fused scan's against that tree's file of the JAX suite run, which
  the suite case shares).
* Suite mode, a repeated `--dataset`, on two TUM directories (8 and 6
  frames: ragged) and on two KITTI roots, `--parity`: the summary JSON has
  the JAX summary's keys, frame counts and per-sequence entries and files,
  each per-sequence trajectory within 1e-3 of JAX's per pose, and the
  `_suite.meta.json` beside them. KITTI roots with different baselines exit 2.
* `--mapping` is held against the JAX CLI in
  `tests/test_torch_mapping_entry.py`, `--live-viz` in
  `tests/test_torch_guards.py::test_viewer_options_are_ported`.
"""

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from vslam_tpu.eval.evaluate import main as jax_main
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.eval.evaluate import main as port_main
from vslam_tpu_torch.io import synthetic, tum

from test_torch_kitti import build_mini_kitti
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

H, W, FX = 96, 128, 110.0
N_FRAMES = 8
INTRINSICS = f"{FX},{FX},{(W - 1) / 2},{(H - 1) / 2}"


@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    return _build_mini_tum(tmp_path_factory.mktemp("mini_tum"), N_FRAMES, seed=11)


@pytest.fixture(scope="module")
def mini_dataset_b(tmp_path_factory):
    return _build_mini_tum(tmp_path_factory.mktemp("mini_tum_b"), 6, seed=5)


def _build_mini_tum(root, n_frames, seed):
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    K = synthetic.camera_matrix(FX, FX, (W - 1) / 2, (H - 1) / 2)
    poses = synthetic.smooth_trajectory(n_frames, trans_amp=0.06, rot_amp=0.02, seed=seed)
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


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    return build_mini_kitti(tmp_path_factory.mktemp("mini_kitti"), seed=4)


@pytest.fixture(scope="module")
def mini_kitti_b(tmp_path_factory):
    return build_mini_kitti(tmp_path_factory.mktemp("mini_kitti_b"), seed=12)


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


def _assert_trajectory_files_close(port_path, jax_path, n):
    got, want = tum.read_trajectory(port_path), tum.read_trajectory(jax_path)
    assert sorted(got) == sorted(want) and len(got) == n
    for t in want:
        assert np.linalg.norm(lie_np.log(lie_np.relative(got[t], want[t]))) < 1e-3, (port_path, t)


def _suite_argv(roots, out, kitti):
    argv = ["odometry"]
    for r in roots:
        argv += ["--dataset", str(r)]
    argv += ["--out", out, "--fused", "--parity", "--chunk", "4"]
    return argv + (["--format", "kitti"] if kitti else ["--intrinsics", INTRINSICS])


def _printed(main, argv):
    """(exit code, the JSON lines ``main(argv)`` prints)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def jax_kitti(mini_kitti, mini_kitti_b, tmp_path_factory):
    """The JAX CLI on the mini-KITTI trees, once for the module: the host
    loop on ``mini_kitti`` ({"lines", "out"}) and the suite of both trees
    ({"summary"}, per-sequence files beside ``out``)."""
    d = tmp_path_factory.mktemp("jax_kitti")
    host = str(d / "host.txt")
    rc, lines = _printed(jax_main, ["odometry", "--dataset", str(mini_kitti), "--format", "kitti", "--sequence", "00",
                                    "--out", host])
    assert rc == 0
    suite = str(d / "suite" / "suite.txt")
    os.makedirs(os.path.dirname(suite))
    rc, summary = _printed(jax_main, _suite_argv([mini_kitti, mini_kitti_b], suite, kitti=True))
    assert rc == 0
    return {"host": {"lines": lines, "out": host}, "suite": {"summary": summary[-1], "out": suite}}


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_kitti_odometry_matches_jax(mini_kitti, jax_kitti, tmp_path, mode):
    """`odometry --format kitti`: stereo PNGs, block-matched depth, tracking,
    the trajectory file, and the ATE against the KITTI ground truth. The
    fused scan is held to the JAX suite's run of the same tree (the suite
    steps each sequence as the single scan does), which spares the module a
    compile of the JAX single-sequence stereo scan."""
    flags = [] if mode == "host" else ["--fused", "--parity", "--chunk", "4"]
    out = str(tmp_path / "port.txt")
    rc, printed = _printed(port_main, ["odometry", "--dataset", str(mini_kitti), "--format", "kitti", "--sequence",
                                       "00", "--out", out, *flags, "--device", "cpu"])
    assert rc == 0
    if mode == "host":
        want = jax_kitti["host"]["out"]
    else:
        want = jax_kitti["suite"]["summary"]["results"][0]["trajectory"]  # the first --dataset
    _assert_trajectory_files_close(out, want, N_FRAMES)
    first, res = printed[0], printed[-1]
    assert first["frames"] == N_FRAMES and res["ate_rmse_m"] < 0.05, printed
    assert sorted(res) == sorted(jax_kitti["host"]["lines"][-1])


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_suite_summary_matches_jax(request, jax_kitti, tmp_path, fmt):
    """A repeated --dataset: one JSON summary, one trajectory file per
    sequence and the suite's meta file, as the JAX CLI writes them."""
    names = ("mini_dataset", "mini_dataset_b") if fmt == "tum" else ("mini_kitti", "mini_kitti_b")
    roots = [request.getfixturevalue(n) for n in names]
    frames = (N_FRAMES, 6) if fmt == "tum" else (N_FRAMES, N_FRAMES)
    summaries = {}
    for pkg, main, extra in (("port", port_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        if pkg == "jax" and fmt == "kitti":
            summaries[pkg] = jax_kitti["suite"]["summary"]
            assert os.path.exists(jax_kitti["suite"]["out"].replace("suite.txt", "suite_suite.meta.json"))
            continue
        out = str(tmp_path / pkg / "suite.txt")
        os.makedirs(os.path.dirname(out))
        rc, lines = _printed(main, _suite_argv(roots, out, kitti=fmt == "kitti") + extra)
        assert rc == 0
        summaries[pkg] = lines[-1]
        assert os.path.exists(str(tmp_path / pkg / "suite_suite.meta.json"))
    got, want = summaries["port"], summaries["jax"]
    assert sorted(got) == sorted(want)
    assert got["sequences"] == want["sequences"] == 2
    assert got["frames"] == want["frames"] == sum(frames)
    assert [e["frames"] for e in got["results"]] == [e["frames"] for e in want["results"]] == list(frames)
    for eg, ej, n in zip(got["results"], want["results"], frames):
        assert sorted(eg) == sorted(ej) and eg["dataset"] == ej["dataset"]
        assert os.path.basename(eg["trajectory"]) == os.path.basename(ej["trajectory"])
        _assert_trajectory_files_close(eg["trajectory"], ej["trajectory"], n)
        assert eg["ate_rmse_m"] < 0.05, eg
    meta = json.loads(open(str(tmp_path / "port" / "suite_suite.meta.json")).read())
    assert meta["config"]["sampler"] == "gather" and meta["results"] == got["results"]


def test_kitti_suite_with_two_baselines_exits_2(mini_kitti, mini_kitti_b, tmp_path, capsys):
    other = tmp_path / "other_baseline"
    shutil.copytree(mini_kitti_b, other)
    calib = other / "sequences" / "00" / "calib.txt"
    calib.write_text(calib.read_text().replace(f"{-FX * 0.54}", f"{-FX * 0.3}"))
    argv = ["odometry", "--dataset", str(mini_kitti), "--dataset", str(other), "--format", "kitti",
            "--out", str(tmp_path / "s.txt"), "--fused", "--device", "cpu"]
    assert port_main(argv) == 2
    assert "baseline" in capsys.readouterr().err
