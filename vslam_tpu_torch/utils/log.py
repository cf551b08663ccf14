"""Logging & observability registry (a copy of `vslam_tpu.utils.log`, with
the port's own registry).

Rebuild of the reference's easylogging++ wrapper (`utils/src/Log.{h,cpp}`):
per-component named loggers ("odometry", "solver", "tracking", "mapping",
"kalman") plus a string-keyed visual-log registry mirroring LOG_IMG/LOG_PLT
(`Log.h:35-177`). Visual logs are null-objects unless enabled — the
reference's ELPP_DISABLE_ALL_LOGS kill switch becomes the default-off state;
enabled sinks save arrays as .npy under a run directory instead of popping
OpenCV windows.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["get_logger", "LogImage", "log_img", "registered_image_logs", "LogPlot", "log_plt",
           "registered_plot_logs", "configure"]

_LOGGERS: Dict[str, logging.Logger] = {}
_IMAGE_LOGS: Dict[str, "LogImage"] = {}
_PLOT_LOGS: Dict[str, "LogPlot"] = {}

_FMT = "%(asctime)s [%(name)s] %(levelname)s %(message)s"


def configure(level: str = "WARNING") -> None:
    logging.basicConfig(level=getattr(logging, level.upper(), logging.WARNING), format=_FMT)


def get_logger(name: str) -> logging.Logger:
    """Named component logger (reference Log::get, Log.cpp:86-92)."""
    if name not in _LOGGERS:
        logger = logging.getLogger(f"vslam_tpu_torch.{name}")
        _LOGGERS[name] = logger
    return _LOGGERS[name]


class LogImage:
    """String-keyed visual log sink (reference LogImage, Log.h:89-137).

    Disabled by default (null-object). When enabled with a save directory,
    `log` stores the array as `<dir>/<name>_<counter>.npy`. An optional
    callback supports custom sinks (plotting, dashboards)."""

    def __init__(self, name: str):
        self.name = name
        self.enabled = False
        self.save_dir: Optional[str] = None
        self.callback: Optional[Callable[[str, np.ndarray], None]] = None
        self._ctr = 0

    def log(self, array) -> None:
        if not self.enabled:
            return
        arr = np.asarray(array)
        if self.callback is not None:
            self.callback(self.name, arr)
        if self.save_dir is not None:
            os.makedirs(self.save_dir, exist_ok=True)
            np.save(os.path.join(self.save_dir, f"{self.name}_{self._ctr:06d}.npy"), arr)
        self._ctr += 1

    def __lshift__(self, array):  # LOG_IMG("x") << mat idiom
        self.log(array)
        return self


def log_img(name: str) -> LogImage:
    if name not in _IMAGE_LOGS:
        _IMAGE_LOGS[name] = LogImage(name)
    return _IMAGE_LOGS[name]


def registered_image_logs():
    return sorted(_IMAGE_LOGS.keys())


class LogPlot:
    """String-keyed plot log sink (reference LogPlot / LOG_PLT, Log.h:35-40,
    139-177). Payloads are dicts of named 1-D arrays (e.g. the Gauss-Newton
    chi2/stepSize iteration history emitted after each solve,
    GaussNewton.cpp:100).

    Disabled by default (null-object). When enabled with a save directory,
    `log` stores the payload as `<dir>/<name>_<counter>.npz` and, when a
    renderer is installed (eval.plot registers the convergence renderer),
    also renders `<name>_<counter>.png`."""

    def __init__(self, name: str):
        self.name = name
        self.enabled = False
        self.save_dir: Optional[str] = None
        self.callback: Optional[Callable[[str, Dict[str, np.ndarray]], None]] = None
        self.renderer: Optional[Callable[[Dict[str, np.ndarray], str], None]] = None
        self._ctr = 0

    def log(self, payload: Dict[str, np.ndarray]) -> None:
        if not self.enabled:
            return
        data = {k: np.asarray(v) for k, v in payload.items()}
        if self.callback is not None:
            self.callback(self.name, data)
        if self.save_dir is not None:
            os.makedirs(self.save_dir, exist_ok=True)
            stem = os.path.join(self.save_dir, f"{self.name}_{self._ctr:06d}")
            np.savez(stem + ".npz", **data)
            if self.renderer is not None:
                self.renderer(data, stem + ".png")
        self._ctr += 1

    def __lshift__(self, payload):  # LOG_PLT("x") << payload idiom
        self.log(payload)
        return self


def log_plt(name: str) -> LogPlot:
    if name not in _PLOT_LOGS:
        _PLOT_LOGS[name] = LogPlot(name)
    return _PLOT_LOGS[name]


def registered_plot_logs():
    return sorted(_PLOT_LOGS.keys())
