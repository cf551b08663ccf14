"""The port's examples (`examples/*_torch.py`) against the JAX package's
(`examples/*.py`): each pair runs here with ``--device cpu`` for the port,
and what they print is compared. The examples print to 4 decimals, so
"within 1e-4" is held on the printed numbers as at most one unit of the
last printed place apart. Tolerances:
* dataset_analysis: identical text, on a TUM file written from
  `io.synthetic.smooth_trajectory`;
* robust_line_fit: the same outlier count, each loss's m and c within 1e-4;
* ekf_motion_analysis: the raw and filtered velocity RMSE within 1e-4 (the
  JAX example always writes its PNG; the port's given a path);
* epipolar_lines: the same correspondence count, the mean and max
  epipolar distance within 1e-4 px;
* loop_closure_scaling: at 20 and 60 keyframes, with and without the
  shortlist, `KeyframeDatabase.query` of both packages on the examples'
  own databases gives None in both or the same keyframe and inlier count
  with `rel` within 1e-5, and scores the same keyframes in the same order;
  both examples print a row for each size.
"""

import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest

from vslam_tpu.features import loop_closure as jlc
from vslam_tpu_torch.core import lie_np
from vslam_tpu_torch.features import loop_closure as tlc
from vslam_tpu_torch.io import synthetic, tum
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _load_example(path):
    """An example script as a module (the examples are not a package)."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def examples(monkeypatch):
    """``load(name)``: (the JAX example, the port's) as modules; the JAX
    examples' edits of sys.path and their argv readers are undone after."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["example"])
    return lambda name: (_load_example(ROOT / "examples" / f"{name}.py"),
                         _load_example(ROOT / "examples" / f"{name}_torch.py"))


def _printed(capsys, main, *args) -> str:
    capsys.readouterr()
    main(*args)
    return capsys.readouterr().out


def _numbers(line: str) -> list:
    return [float(x) for x in NUMBER.findall(line)]


def _same_to_4_decimals(a, b) -> bool:
    """Printed 4-decimal numbers at most one unit of the last place apart."""
    return all(abs(round(x * 1e4) - round(y * 1e4)) <= 1 for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("n_frames", [1, 40])
def test_dataset_analysis_prints_the_same_text(examples, capsys, tmp_path, n_frames):
    path = tmp_path / "groundtruth.txt"
    poses = synthetic.smooth_trajectory(n_frames)
    tum.write_trajectory(str(path), {i / 30.0: lie_np.inv(p) for i, p in enumerate(poses)})
    jax_ex, port = examples("dataset_analysis")
    want = _printed(capsys, jax_ex.main, str(path))
    got = _printed(capsys, port.main, [str(path)])
    assert got == want
    assert len(got.splitlines()) == (1 if n_frames == 1 else 5)


def test_robust_line_fit_matches_jax(examples, capsys):
    jax_ex, port = examples("robust_line_fit")
    want = _printed(capsys, jax_ex.main).splitlines()
    got = _printed(capsys, port.main, ["--device", "cpu"]).splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0]  # the ground truth and the outlier count
    for g, w in zip(got[1:], want[1:]):
        assert g.split(":")[0] == w.split(":")[0]  # the loss
        assert _same_to_4_decimals(_numbers(g.split(":")[1]), _numbers(w.split(":")[1])), (g, w)


def test_ekf_motion_analysis_matches_jax(examples, capsys, tmp_path):
    jax_ex, port = examples("ekf_motion_analysis")
    want = _printed(capsys, jax_ex.main, str(tmp_path / "jax.png")).splitlines()
    got = _printed(capsys, port.main, [str(tmp_path / "port.png"), "--device", "cpu"]).splitlines()
    assert got[0].startswith("velocity RMSE raw") and want[0].startswith("velocity RMSE raw")
    assert _same_to_4_decimals(_numbers(got[0]), _numbers(want[0])), (got[0], want[0])
    assert (tmp_path / "jax.png").stat().st_size > 0 and (tmp_path / "port.png").stat().st_size > 0
    # without a path the port's example plots nothing
    assert _printed(capsys, port.main, ["--device", "cpu"]).splitlines() == got[:1]


def test_epipolar_lines_matches_jax(examples, capsys):
    jax_ex, port = examples("epipolar_lines")
    want = _printed(capsys, jax_ex.main)
    got = _printed(capsys, port.main, ["--device", "cpu"])
    (n_got, mean_got, max_got), (n_want, mean_want, max_want) = _numbers(got), _numbers(want)
    assert n_got == n_want > 0
    assert _same_to_4_decimals((mean_got, max_got), (mean_want, max_want)), (got, want)


class _Revisit:
    """A query keyframe that sees keyframe ``entry`` again from the pose
    ``T`` (its points moved by T, its descriptors the same)."""

    def __init__(self, entry, T, template):
        p = entry.p_cam @ T[:3, :3].T + T[:3, 3]
        cam = template.frame.cameras[0]
        self.id = 10**9 + 1
        self.descriptors = entry.descriptors.copy()
        self.kp_depth = p[:, 2]
        self.keypoints = np.stack([p[:, 0] / p[:, 2] * cam.fx + cam.cx, p[:, 1] / p[:, 2] * cam.fy + cam.cy], 1)
        self.frame = template.frame


def _query(module, monkeypatch, db, q):
    """(db.query(q), the keyframe ids scored in order): a spy on the
    module's descriptor packing, which each scored entry goes through."""
    ids = {id(e.descriptors): e.kf_id for e in db._entries}
    scored, real = [], module._as_packed

    def spy(desc):
        if id(desc) in ids:
            scored.append(ids[id(desc)])
        return real(desc)

    monkeypatch.setattr(module, "_as_packed", spy)
    try:
        return db.query(q), scored
    finally:
        monkeypatch.setattr(module, "_as_packed", real)


@pytest.mark.parametrize("max_candidates", [5, 0], ids=["shortlist", "full_scan"])
@pytest.mark.parametrize("n", [20, 60])
def test_loop_closure_query_matches_jax(examples, monkeypatch, n, max_candidates):
    jax_ex, port = examples("loop_closure_scaling")
    jdb = jax_ex.build_db(n, jlc.LoopClosureConfig(min_gap=2, max_candidates=max_candidates),
                          np.random.default_rng(1))
    tdb = port.build_db(n, tlc.LoopClosureConfig(min_gap=2, max_candidates=max_candidates),
                        np.random.default_rng(1), "cpu")
    template = port._Query(np.random.default_rng(0))
    T = lie_np.exp(np.array([0.05, -0.02, 0.03, 0.02, 0.01, -0.03]))
    queries = {"example": (jax_ex._Query(np.random.default_rng(0)), template),
               "revisit": (_Revisit(jdb._entries[5], T, template), _Revisit(tdb._entries[5], T, template))}
    for name, (jq, tq) in queries.items():
        (want, want_scored), (got, got_scored) = _query(jlc, monkeypatch, jdb, jq), _query(tlc, monkeypatch, tdb, tq)
        assert got_scored == want_scored, name
        assert len(got_scored) == (max_candidates or n - 2)
        if want is None:
            assert got is None, name
            continue
        assert (got.kf_id, got.n_inliers) == (want.kf_id, want.n_inliers), name
        np.testing.assert_allclose(got.rel, want.rel, atol=1e-5)
    # the revisit is found, with every point an inlier, at its pose
    assert got.kf_id == 5 and got.n_inliers == 200 and 5 in got_scored
    np.testing.assert_allclose(got.rel, T, atol=1e-5)


def test_loop_closure_scaling_prints_a_row_a_size(examples, capsys):
    jax_ex, port = examples("loop_closure_scaling")
    want = _printed(capsys, jax_ex.main, [20, 60]).splitlines()
    got = _printed(capsys, port.main, ["20", "60", "--device", "cpu"]).splitlines()
    assert [r.split()[0] for r in want[1:]] == [r.split()[0] for r in got[1:]] == ["20", "60"]
    # the port's rows add each mode's answer: the example's query finds no loop
    assert [r.split()[3:] for r in got[1:]] == [["none", "none"]] * 2
