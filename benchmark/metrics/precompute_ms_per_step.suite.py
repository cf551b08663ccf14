"""precompute_ms_per_step.suite: device milliseconds a scan step of the
suite spends selecting the current frame's interest points: the program's
span "align.precompute" (`alignment/ic.precompute_level`, once a level)
inside "scan.step", timed on the device by its stream markers
(`program.py`), over the traced steps. Moves frames_per_s."""

from benchmark import program


def read(run):
    if run.kind != "suite":
        return None
    return program.device_ms_per("align.precompute", per="scan.step", within="scan.step")
