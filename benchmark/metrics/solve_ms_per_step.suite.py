"""solve_ms_per_step.suite: device milliseconds a scan step of the suite
spends in the level solves: the program's span "align.solve" (around
`solve_level` in `alignment/ic.align`'s level loop: the whole-level GN
kernel and its glue) inside "scan.step", timed on the device by its stream
markers (`program.py`), over the traced steps. Moves frames_per_s."""

from benchmark import program


def read(run):
    if run.kind != "suite":
        return None
    return program.device_ms_per("align.solve", per="scan.step", within="scan.step")
