"""device_idle_pct.pairs: the share of the traced `align_pairs` calls, in %,
in which no operation ran on the card (kernels, copies and sets from the
profiler's device records). Moves pairs_per_s."""


def read(run):
    tr = run.trace
    if run.kind != "pairs" or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
