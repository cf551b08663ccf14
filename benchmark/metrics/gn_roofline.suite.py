"""gn_roofline.suite: the Gauss-Newton kernel's share of its roofline in the
suite, in %: the least time the traced passes' GN work needs at the H100's
published peaks (`work.py`, counted from the reference's iterations) over
the device time of the ``solve_level_kernel`` operations in the trace.
Moves frames_per_s."""


def read(run):
    busy = run.trace.kernel_s("solve_level_kernel")
    if run.kind != "suite" or not busy or run.gn_least_s is None:
        return None
    return 100.0 * run.gn_least_s / busy
