"""gn_iterations_per_solve.suite: accepted Gauss-Newton iterations a level
solve of the suite: the program's counters "align.gn_iterations" (each
level's accepted iterations, summed over the pairs) over "align.gn_solves"
(pairs a level), both counted in `alignment/ic.align` during the traced
passes (`program.py`). Moves frames_per_s."""

from benchmark import program


def read(run):
    return program.counter_ratio("align.gn_iterations", "align.gn_solves") if run.kind == "suite" else None
