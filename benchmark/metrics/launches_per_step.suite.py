"""launches_per_step.suite: the host's kernel launch calls (``cudaLaunch*``
and ``cuLaunch*`` under `torch.profiler`) a scan step of the suite, over the
traced passes. Moves frames_per_s."""


def read(run):
    if run.kind != "suite" or not run.steps or not run.trace.launches:
        return None
    return run.trace.launches / run.steps
