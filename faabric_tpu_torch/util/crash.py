"""Fatal-signal crash handler.

Counterpart of ``faabric_tpu/util/crash.py`` (reference
include/faabric/util/crash.h:10-16, a native stack-trace printer):
``faulthandler`` dumps every thread's Python stack on SIGSEGV, SIGFPE,
SIGABRT and SIGBUS, and on demand on SIGUSR1 without stopping the
process."""

from __future__ import annotations

import faulthandler
import signal
import sys

_installed = False


def install_crash_handler() -> None:
    global _installed
    if _installed:
        return
    _installed = True
    faulthandler.enable(file=sys.stderr, all_threads=True)
    try:
        # A live dump: kill -USR1 <pid> prints all stacks
        faulthandler.register(signal.SIGUSR1, file=sys.stderr,
                              all_threads=True)
    except (AttributeError, ValueError):  # pragma: no cover — non-POSIX
        pass
