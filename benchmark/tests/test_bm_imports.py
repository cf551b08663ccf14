"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names compared whole (the port's name begins with the JAX
package's)."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH_DIR = Path(harness.__file__).resolve().parent
FORBIDDEN = set(harness.FORBIDDEN)


def test_no_source_of_the_benchmark_imports_them():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            assert not {n.partition(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_a_loaded_harness_holds_none_of_them():
    code = (
        "import sys, benchmark.placement, benchmark.harness as h\n"
        "import benchmark.runners, benchmark.checks, benchmark.trace\n"
        "import vslam_tpu_torch.parallel.sequences, vslam_tpu_torch.parallel.batched\n"
        "print(h.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vslam_tpu_torch_fake.x", sys)
    assert "vslam_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "vslam_tpu.core", sys)
    assert {"jaxlib", "vslam_tpu"} <= set(harness.forbidden_modules())


def test_no_card_no_result():
    """Without CUDA the command prints no result and exits non-zero."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tum_suite", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "placement: CPUs " in out.stderr  # placed before it looked for a card
