"""frame_build_ms_per_step.suite: device milliseconds a scan step of the
suite spends building the current frame: the program's span "frame.build"
(`odometry/sequential._sensor_frame`: widening the sensor images, depth,
the pyramid) inside "scan.step", timed on the device by its stream markers
(`program.py`), over the traced steps. Moves frames_per_s."""

from benchmark import program


def read(run):
    if run.kind != "suite":
        return None
    return program.device_ms_per("frame.build", per="scan.step", within="scan.step")
