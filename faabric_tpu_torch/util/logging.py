"""Logging setup.

Counterpart of ``faabric_tpu/util/logging.py``: ``LOG_LEVEL`` and
``LOG_FILE`` choose the level and the sink.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}

_initialised = False


def init_logging() -> None:
    global _initialised
    if _initialised:
        return
    level = _LEVELS.get(os.environ.get("LOG_LEVEL", "info").lower(),
                        logging.INFO)
    log_file = os.environ.get("LOG_FILE", "off")
    if log_file not in ("", "off"):
        handler: logging.Handler = logging.FileHandler(log_file)
    else:
        handler = logging.StreamHandler(sys.stderr)
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(levelname).1s] %(name)s: %(message)s",
        handlers=[handler],
    )
    _initialised = True


def get_logger(name: str) -> logging.Logger:
    init_logging()
    return logging.getLogger(name)
