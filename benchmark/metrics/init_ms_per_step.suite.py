"""init_ms_per_step.suite: host milliseconds a scan step of the suite
spends starting a pass: the program's span "suite.init_states"
(`parallel/sequences.MultiSequenceOdometry._run_chunks`: stacking the
first frames, their upload and `init_states`), timed in the trace, less
the time inside CUDA runtime and driver calls within it, over the traced
steps. Moves frames_per_s."""

from benchmark import program


def read(run):
    return program.host_ms_per_step(run, "suite.init_states") if run.kind == "suite" else None
