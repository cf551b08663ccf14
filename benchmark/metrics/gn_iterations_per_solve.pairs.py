"""gn_iterations_per_solve.pairs: accepted Gauss-Newton iterations a level
solve of the pair batch: the program's counters "align.gn_iterations"
(each level's accepted iterations, summed over the pairs) over
"align.gn_solves" (pairs a level), both counted in `alignment/ic.align`
during the traced calls (`program.py`). Moves pairs_per_s."""

from benchmark import program


def read(run):
    return program.counter_ratio("align.gn_iterations", "align.gn_solves") if run.kind == "pairs" else None
