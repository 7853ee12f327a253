"""Logging/verbosity layer (reference glog passthrough:
``tudocomp_driver/Options.hpp:15-32`` ``--logdir/--loglevel/
--logverbosity``).

The port's copy of ``tudocomp_tpu/utils/log.py``. A thin veneer over
:mod:`logging`: every module logs through ``tudocomp_tpu_torch.<area>``
loggers; the CLI (and the ``TDC_LOGLEVEL`` / ``TDC_LOGDIR`` /
``TDC_LOGVERBOSITY`` variables) configure level, optional per-run file
output, and a glog-style VLOG verbosity gate.
"""

from __future__ import annotations

import logging
import os
import time

_ROOT = logging.getLogger("tudocomp_tpu_torch")
_VERBOSITY = 0
_FILE_DIR: str | None = None  # logdir a FileHandler was attached for


def get_logger(area: str) -> logging.Logger:
    return _ROOT.getChild(area)


def vlog(level: int) -> bool:
    """glog VLOG(level) gate: true when --logverbosity >= level."""
    return _VERBOSITY >= level


def configure(loglevel: str | None = None, logdir: str | None = None,
              logverbosity: int | None = None) -> None:
    """Apply the CLI/env logging options (idempotent)."""
    global _VERBOSITY, _FILE_DIR
    loglevel = loglevel or os.environ.get("TDC_LOGLEVEL")
    logdir = logdir or os.environ.get("TDC_LOGDIR")
    if logverbosity is None:
        logverbosity = int(os.environ.get("TDC_LOGVERBOSITY", "0"))
    _VERBOSITY = logverbosity
    if loglevel:
        _ROOT.setLevel(loglevel.upper())
        has_console = any(
            type(h) is logging.StreamHandler for h in _ROOT.handlers
        )
        if not has_console:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(levelname).1s %(asctime)s %(name)s] %(message)s",
                datefmt="%H:%M:%S",
            ))
            _ROOT.addHandler(h)
    if logdir and logdir != _FILE_DIR:  # one FileHandler per logdir
        _FILE_DIR = logdir
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(
            logdir, f"tdc.{time.strftime('%Y%m%d-%H%M%S')}.log"
        )
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(
            "%(levelname).1s %(asctime)s %(name)s] %(message)s"
        ))
        _ROOT.addHandler(fh)
        if _ROOT.level == logging.NOTSET:
            _ROOT.setLevel(logging.INFO)
