"""The port's bench (`vslam_tpu_torch.bench`) against the repository's
`bench.py`, on the CPU.

* The JSON keys each sub-bench can return, the ``BENCH_*`` variables with
  their defaults and the sub-benches' order and switches equal
  `bench.py`'s, read from both sources with `ast` (`bench.py` imports the
  JAX package at run time, so it is not imported), less the ``mfu_*``
  stanza and the TPU-only switches the port does not carry.
* `pair_batch` at B = 2, 60x80 renders bit for bit what `bench.py`'s
  recipe (:117-126) renders with the JAX package's `io/synthetic` and
  `lie_np`.
* The headline gate's per-pair errors on those pairs equal those of the
  JAX package's `align_pairs` on the same numpy images within ERR_TOL; the
  rep loop makes REPS calls, each from the previous call's output.

The JAX comparison runs the `gather` sampler, which reaches no Pallas
kernel: the whole-level kernel in interpret mode costs the JAX side about
half a minute more. The port's `fused_gn` is held to the JAX kernel by
`tests/test_torch_align.py`. The odometry sub-bench's comparison is
`tests/test_torch_bench_odometry.py`, a file of its own so that each file
stays under a minute on one worker.
* `python -m vslam_tpu_torch.bench` without a card prints one JSON line
  with ``error`` and exits 1; a sub-bench that raises gives its
  ``{name}_error`` key and exit 1; a failed headline gate gives its
  failure line alone and exit 1.
"""

import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.alignment.ic import AlignmentConfig as JAlignmentConfig
from vslam_tpu.core import lie_np as jlie
from vslam_tpu.core.camera import Camera as JCamera
from vslam_tpu.core.frame import create_frame as j_create_frame
from vslam_tpu.core.se3 import SE3 as JSE3
from vslam_tpu.io import synthetic as jsyn
from vslam_tpu.parallel.batched import align_pairs as j_align_pairs
from vslam_tpu.solvers import SolverConfig as JSolverConfig
from vslam_tpu_torch import bench
from vslam_tpu_torch.core.se3 import SE3
from torch_threads import one_torch_thread  # noqa: F401 (autouse: one torch thread)

REPO = Path(__file__).resolve().parent.parent
B, H, W = 2, 60, 80
REPS = 3
ERR_TOL = 1e-4  # per-pair SE(3) error, port against JAX (f32 chains, another summation order)

# `bench.py`'s function -> the port's functions that return its keys
COUNTERPARTS = {
    "main": ("main", "align_pairs_rate", "run_all"),
    "_link_health": ("link_health",),
    "bench_real": ("real",),
    "bench_host": ("host",),
    "bench_odometry_fps": ("odometry",),
    "bench_multiseq": ("multiseq",),
    "bench_slam": ("slam",),
    "bench_slam_drift": ("slam_drift",),
    "bench_kitti": ("kitti",),
    "bench_kitti_loop": ("kitti_loop",),
}
# `bench.py`'s switches and knobs of the TPU alone, not ported
NOT_PORTED = {"BENCH_PROBE_TIMEOUT", "BENCH_ALLOW_CPU", "BENCH_FORCE_CPU", "BENCH_MFU"}


def _functions(path):
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


JAX_FNS = _functions(REPO / "bench.py")
PORT_FNS = _functions(REPO / "vslam_tpu_torch" / "bench.py")


def _str(node):
    return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else None


def _keys(fn) -> set:
    """The string keys of the dict literals in ``fn`` and of its
    ``d["key"] = ...`` assignments."""
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {_str(k) for k in node.keys} - {None}
        elif isinstance(node, ast.Assign):
            keys |= {_str(t.slice) for t in node.targets if isinstance(t, ast.Subscript)} - {None}
    return keys


def _env_defaults(fns) -> dict:
    """{BENCH_* variable: its default as a string} over ``fns``: the
    ``os.environ.get(name, default)`` calls and the port's
    ``_env_int(name, default)``."""
    out = {}
    for fn in fns:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and len(node.args) == 2):
                continue
            f = node.func
            is_get = isinstance(f, ast.Attribute) and f.attr == "get"
            is_int = isinstance(f, ast.Name) and f.id == "_env_int"
            name = _str(node.args[0])
            if (is_get or is_int) and name and name.startswith("BENCH_"):
                out[name] = str(node.args[1].value)
    return out


@pytest.mark.parametrize("jax_fn", list(COUNTERPARTS))
def test_keys_match_bench_py(jax_fn):
    want = {k for k in _keys(JAX_FNS[jax_fn]) if not k.startswith("mfu_")}
    got = set().union(*(_keys(PORT_FNS[f]) for f in COUNTERPARTS[jax_fn]))
    if jax_fn == "main":
        got.discard("device")  # the port's line names the card
    assert got == want


def test_env_variables_and_defaults_match_bench_py():
    want = {k: v for k, v in _env_defaults(JAX_FNS.values()).items() if k not in NOT_PORTED}
    assert _env_defaults(PORT_FNS.values()) == want


def test_sub_bench_order_and_switches_match_bench_py():
    guards = [node for node in ast.walk(JAX_FNS["main"])
              if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "_guard"]
    want = [(_str(g.args[0]), _str(g.args[1])) for g in guards if _str(g.args[1]) not in NOT_PORTED]
    assert [(name, switch) for name, switch, _ in bench._sub_benches("cpu")] == want
    assert sorted(bench._MERGE_ORDER) == sorted(name for name, _ in want)


@pytest.fixture(scope="module")
def pairs():
    return bench.pair_batch(B, H, W, device="cpu")


def test_pair_batch_renders_bench_py_recipe(pairs):
    fx = 525.0 * W / 640
    K = jsyn.camera_matrix(fx, fx, (W - 1) / 2, (H - 1) / 2)
    rng = np.random.default_rng(0)
    for b in range(B):
        scene = jsyn.default_scene(seed=b)
        xi = np.concatenate([rng.uniform(-0.01, 0.01, 3), rng.uniform(-0.005, 0.005, 3)])
        np.testing.assert_array_equal(pairs.xis[b], xi)
        for frame, pose in ((pairs.ref, np.eye(4)), (pairs.cur, jlie.exp(xi))):
            inten, depth = jsyn.render(K, pose, (H, W), scene)
            np.testing.assert_array_equal(frame.intensity[0][b].numpy(), inten)
            np.testing.assert_array_equal(frame.depth[0][b].numpy(), depth)
    assert float(pairs.ref.cameras[0].fx[0]) == np.float32(fx)
    assert pairs.ref.n_levels == 3
    torch.testing.assert_close(pairs.rel0.R, torch.eye(3).expand(B, 3, 3), rtol=0, atol=0)
    assert not pairs.rel0.t.any() and not pairs.x_pred.any()


@pytest.fixture(scope="module")
def headline():
    """The headline at B = 2, 60x80, REPS reps on the CPU with
    `align_pairs` wrapped: (the returned line, [(rel_in, rel_out, cfg) of
    each call])."""
    calls = []
    real = bench.align_pairs

    def wrapped(ref, cur, rel_in, x_pred, cfg):
        out = real(ref, cur, rel_in, x_pred, cfg)
        calls.append((SE3(rel_in.R.clone(), rel_in.t.clone()), out[0], cfg))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "align_pairs", wrapped)
        line = bench.align_pairs_rate(batch=B, height=H, width=W, reps=REPS, sampler="gather",
                                      image_dtype="float32", device="cpu")
    return line, calls


def test_rep_loop_carries_each_output_into_the_next_call(headline, pairs):
    line, calls = headline
    assert len(calls) == 1 + REPS  # the warm call, then the loop
    assert line["value"] > 0 and line["metric"] == bench.METRIC and line["vs_baseline"] is None
    rel0 = pairs.rel0
    assert torch.equal(calls[0][0].R, rel0.R) and torch.equal(calls[0][0].t, rel0.t)
    for j in range(REPS):
        prev = rel0 if j == 0 else calls[j][1]
        rel_in = calls[j + 1][0]
        assert torch.equal(rel_in.R, rel0.R + 1e-30 * prev.R)
        assert torch.equal(rel_in.t, rel0.t + 1e-30 * prev.t)
        if j > 0:  # the carry is numerically zero but not zero
            assert rel_in.t.abs().min() > 0
    cfg = calls[0][2]
    assert all(c[2] == cfg for c in calls)
    assert (cfg.sampler, cfg.interpolation, cfg.image_dtype, cfg.max_points, cfg.include_prior) == (
        "gather", "nearest", "float32", 2048, True)
    # the production profile is the default
    defaults = {k: p.default for k, p in inspect.signature(bench.align_pairs_rate).parameters.items()}
    assert defaults == {"batch": 64, "height": 480, "width": 640, "reps": 10, "points": 2048, "sampler": "fused_gn",
                        "interpolation": "nearest", "image_dtype": "bfloat16", "device": None}


def test_headline_gate_errors_match_jax(headline, pairs):
    _, calls = headline
    cfg = calls[0][2]
    errs = bench.pair_errors(calls[0][1], pairs.xis)

    fx = 525.0 * W / 640
    cam = JCamera.create(fx, fx, (W - 1) / 2, (H - 1) / 2)

    # one compiled program for the B pyramids (`bench.py` builds them one
    # by one, op by op: the same math, ~10 s more here)
    build = jax.jit(jax.vmap(lambda i, d: j_create_frame(i, d, cam, n_levels=3)))
    frames = lambda f: build(jnp.asarray(f.intensity[0].numpy()), jnp.asarray(f.depth[0].numpy()))  # noqa: E731

    jcfg = JAlignmentConfig(  # `bench.py:137-163`
        min_gradient=30.0,
        solver=JSolverConfig(max_iterations=100, min_step_size=1e-11, min_relative_reduction=1e-4),
        include_prior=True, interpolation="nearest", sampler="gather", image_dtype="float32", max_points=2048)
    rel0 = JSE3(jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (B, 3, 3)), jnp.zeros((B, 3), jnp.float32))
    rel, _, _ = j_align_pairs(frames(pairs.ref), frames(pairs.cur), rel0, jnp.zeros((B, 6), jnp.float32), jcfg)
    R_all, t_all = np.asarray(rel.R, np.float64), np.asarray(rel.t, np.float64)
    want = []
    for b in range(B):  # `bench.py:176-182`
        T = np.eye(4)
        u, _, vt = np.linalg.svd(R_all[b])
        T[:3, :3] = u @ vt
        T[:3, 3] = t_all[b]
        want.append(np.linalg.norm(jlie.log(T) - pairs.xis[b]))
    np.testing.assert_allclose(errs, want, rtol=0, atol=ERR_TOL)
    assert errs.mean() < 0.01


def test_main_without_a_card_prints_one_error_line():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "vslam_tpu_torch.bench"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert "error" in line and line["value"] == 0.0 and line["vs_baseline"] is None


HEAD = {"metric": bench.METRIC, "value": 123.0, "unit": "pairs/s", "vs_baseline": None,
        "methodology": "v3-honest-loop-carry"}


@pytest.fixture
def card(monkeypatch):
    """`main` as on a card, its headline, link check and build stubbed,
    every sub-bench switched off; returns a function running `main` and
    giving (exit code, its last stdout line as a dict)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "_card", lambda: "a card, 700.00 W")
    monkeypatch.setattr(bench._build, "build", lambda: None)
    monkeypatch.setattr(bench, "align_pairs_rate", lambda **kw: dict(HEAD))
    monkeypatch.setattr(bench, "link_health", lambda device=None: {"link_rtt_ms": 0.1})
    for _, switch, _ in bench._sub_benches("cpu"):
        monkeypatch.setenv(switch, "0")

    def run_main(capsys):
        rc = bench.main()
        return rc, json.loads(capsys.readouterr().out.splitlines()[-1])

    return run_main


def test_failed_sub_bench_gives_its_error_key_and_exit_1(card, capsys, monkeypatch):
    def fails(**kw):
        raise RuntimeError("the sub-bench broke")

    monkeypatch.setattr(bench, "odometry", fails)
    monkeypatch.setattr(bench, "host", lambda **kw: {"host_fps": 5.0})
    monkeypatch.setenv("BENCH_ODOMETRY", "1")
    monkeypatch.setenv("BENCH_HOST", "1")
    rc, line = card(capsys)
    assert rc == 1
    assert line["odometry_error"] == "the sub-bench broke"
    assert line["host_fps"] == 5.0 and line["value"] == 123.0 and line["device"] == "a card, 700.00 W"


def test_passing_run_exits_0_and_a_spent_budget_skips(card, capsys, monkeypatch):
    monkeypatch.setattr(bench, "host", lambda **kw: {"host_fps": 5.0})
    monkeypatch.setenv("BENCH_HOST", "1")
    rc, line = card(capsys)
    assert rc == 0 and line == {**HEAD, "device": "a card, 700.00 W", "link_rtt_ms": 0.1, "host_fps": 5.0}
    monkeypatch.setenv("BENCH_TIME_BUDGET", "0")
    rc, line = card(capsys)
    assert rc == 0 and "host_skipped" in line and "host_fps" not in line


def test_failed_headline_gate_prints_its_line_alone_and_exits_1(card, capsys, monkeypatch):
    failed = {"metric": "aligned frame-pairs/sec/chip (ACCURACY GATE FAILED)", "value": 0.0, "unit": "pairs/s",
              "vs_baseline": None}
    monkeypatch.setattr(bench, "align_pairs_rate", lambda **kw: dict(failed))
    monkeypatch.setenv("BENCH_HOST", "1")
    monkeypatch.setattr(bench, "host", lambda **kw: pytest.fail("a sub-bench ran after a failed gate"))
    rc, line = card(capsys)
    assert rc == 1 and line == {**failed, "device": "a card, 700.00 W"}
