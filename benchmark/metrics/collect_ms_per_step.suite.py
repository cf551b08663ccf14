"""collect_ms_per_step.suite: host milliseconds a scan step of the suite
spends collecting results: the program's span "suite.collect"
(`parallel/sequences.MultiSequenceOdometry._collect`: a chunk's fetch and
the host's SVDs of its poses), timed in the trace, less the time inside
CUDA runtime and driver calls within it, where the host waits for the
card, over the traced steps. Moves frames_per_s."""

from benchmark import program


def read(run):
    return program.host_ms_per_step(run, "suite.collect") if run.kind == "suite" else None
