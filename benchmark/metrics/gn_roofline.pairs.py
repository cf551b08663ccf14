"""gn_roofline.pairs: the Gauss-Newton kernel's share of its roofline in the
pair batch, in %: the least time the traced calls' GN work needs at the
H100's published peaks (`work.py`, counted from the reference's iterations)
over the device time of the ``solve_level_kernel`` operations in the trace.
Moves pairs_per_s."""


def read(run):
    busy = run.trace.kernel_s("solve_level_kernel")
    if run.kind != "pairs" or not busy or run.gn_least_s is None:
        return None
    return 100.0 * run.gn_least_s / busy
