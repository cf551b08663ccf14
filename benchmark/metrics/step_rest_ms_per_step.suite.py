"""step_rest_ms_per_step.suite: device milliseconds of a scan step of the
suite outside frame build, precompute and the level solves: the program's
span "scan.step" (`odometry/sequential.scan_odometry`, around each `_step`)
less its children "frame.build", "align.precompute" and "align.solve", all
timed on the device by their stream markers (`program.py`), over the
traced steps. It holds the motion model, the EKF, the keyframe choice, the
state `_select`s and the level glue. Moves frames_per_s."""

from benchmark import program


def read(run):
    if run.kind != "suite":
        return None
    return program.self_ms_per("scan.step", ("frame.build", "align.precompute", "align.solve"), per="scan.step")
