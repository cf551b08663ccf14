"""device_idle_pct.suite: the share of the traced suite passes, in %, in
which no operation ran on the card (kernels, copies and sets from the
profiler's device records). Moves frames_per_s."""


def read(run):
    tr = run.trace
    if run.kind != "suite" or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
