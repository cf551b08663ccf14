"""launches_per_call.pairs: the host's kernel launch calls (``cudaLaunch*``
and ``cuLaunch*`` under `torch.profiler`) an `align_pairs` call, over the
traced calls. Moves pairs_per_s."""


def read(run):
    if run.kind != "pairs" or not run.steps or not run.trace.launches:
        return None
    return run.trace.launches / run.steps
