"""Test and mock modes.

Counterpart of ``faabric_tpu/util/testing.py``: with mock mode on, the
RPC clients record their calls instead of sending them, and tests read
the recordings. Test mode is the flag the reference's fixtures raise
around every test.
"""

from __future__ import annotations

_test_mode = False
_mock_mode = False


def set_test_mode(value: bool) -> None:
    global _test_mode
    _test_mode = value


def is_test_mode() -> bool:
    return _test_mode


def set_mock_mode(value: bool) -> None:
    global _mock_mode
    _mock_mode = value


def is_mock_mode() -> bool:
    return _mock_mode
