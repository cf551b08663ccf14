"""solve_ms_per_call.pairs: device milliseconds an `align_pairs` call
spends in the level solves: the program's span "align.solve" (around
`solve_level` in `alignment/ic.align`'s level loop) inside "align", timed
on the device by its stream markers (`program.py`), over the traced calls.
Moves pairs_per_s."""

from benchmark import program


def read(run):
    return program.device_ms_per("align.solve", per="align", within="align") if run.kind == "pairs" else None
