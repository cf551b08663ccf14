"""dispatch_ms_per_step.suite: host milliseconds a scan step spends on the
suite host loop's own dispatch work: the program's `utils.timer` span
"suite.dispatch" (`parallel/sequences`: enqueueing a chunk's steps, no fetch
inside), timed in the trace, less the time inside CUDA runtime and driver
calls within it, over the steps traced. Those calls are left out because,
once about a thousand launches are queued, the host blocks in them until
the card frees a slot, and that wait reads the card's pace, not the host's.
So a cheaper dispatch (fewer or lighter host operations a step) moves it
and a faster kernel does not. Moves frames_per_s."""


def read(run):
    span = run.trace.spans.get("suite.dispatch") if run.kind == "suite" else None
    if not span or not run.steps or span[0] <= span[1]:
        return None
    return 1e3 * (span[0] - span[1]) / run.steps
