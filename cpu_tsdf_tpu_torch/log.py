"""Leveled logging for the framework (SURVEY §5 metrics/logging).

The reference logs through PCL console macros gated by ``--verbose``
(cpu_tsdf/src/prog/integrate.cpp:312,468,630). Here the standard
``logging`` module carries the same roles: INFO for pipeline progress,
DEBUG behind --verbose, WARNING/ERROR for recoverable/fatal conditions.
Messages go to stdout (matching the reference's console behavior); callers
can reconfigure the ``cpu_tsdf_tpu_torch`` logger like any other.
"""

from __future__ import annotations

import logging
import sys

_LOGGER = None


def get_logger(verbose: bool = False) -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        log = logging.getLogger("cpu_tsdf_tpu_torch")
        if not log.handlers:
            h = logging.StreamHandler(sys.stdout)
            h.setFormatter(logging.Formatter("%(message)s"))
            log.addHandler(h)
        log.propagate = False
        _LOGGER = log
    _LOGGER.setLevel(logging.DEBUG if verbose else logging.INFO)
    return _LOGGER
