"""Step hang watchdog (counterpart of paddle_tpu/utils/watchdog.py).

The host cannot interrupt a kernel, but it can observe that a blocking
region (an engine step's device call, a training step) never finished.
The watchdog arms a timer around the region; if the region does not
finish in time it dumps the stacks of every Python thread to stderr and
either warns or aborts the process (FLAGS_watchdog_abort) so that a
supervisor can restart it. Zero overhead when unarmed.

    from paddle_tpu_torch.utils.watchdog import watchdog
    with watchdog(120, what="train step"):
        loss = step(ids, labels)

or process-wide through the flags:
    paddle_tpu_torch.set_flags({"FLAGS_watchdog_timeout_s": 300})
"""
from __future__ import annotations

import faulthandler
import os
import sys
import threading
from contextlib import contextmanager

from ..core.flags import get_flags

__all__ = ["watchdog"]


def _flag(name):
    # fails loudly on an unknown name (a typo must not silently
    # disarm the watchdog); get_flags returns {name: value}
    return get_flags(name)[name]


class _Watchdog:
    def __init__(self, timeout_s: float, what: str, abort: bool):
        self.timeout_s = timeout_s
        self.what = what
        self.abort = abort
        self._done = threading.Event()
        self._timer = None

    def _fire(self):
        if self._done.is_set():
            return
        sys.stderr.write(
            f"\n[paddle_tpu_torch watchdog] {self.what!r} exceeded "
            f"{self.timeout_s:.0f}s: likely a hung collective or "
            "device deadlock. Thread stacks follow.\n")
        sys.stderr.flush()
        try:
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            # a replaced stderr (a notebook, StringIO) has no fileno;
            # the abort below must still run, so fall back to the
            # pure-Python dump
            import traceback
            for tid, frame in sys._current_frames().items():
                sys.stderr.write(f"Thread {tid:#x}:\n")
                traceback.print_stack(frame, file=sys.stderr)
            sys.stderr.flush()
        if self.abort:
            sys.stderr.write(
                "[paddle_tpu_torch watchdog] aborting "
                "(FLAGS_watchdog_abort set) so a supervisor can restart "
                "this worker\n")
            sys.stderr.flush()
            os._exit(124)

    def __enter__(self):
        if self.timeout_s > 0:
            self._timer = threading.Timer(self.timeout_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        if self._timer is not None:
            self._timer.cancel()
        return False


@contextmanager
def watchdog(timeout_s: float = None, what: str = "blocking region",
             abort: bool = None):
    """Arm a hang detector around a blocking region. timeout_s=None
    reads FLAGS_watchdog_timeout_s (0 = disarmed); abort=None reads
    FLAGS_watchdog_abort (default: warn only)."""
    if timeout_s is None:
        timeout_s = float(_flag("FLAGS_watchdog_timeout_s") or 0.0)
    if abort is None:
        abort = bool(_flag("FLAGS_watchdog_abort"))
    if not timeout_s:
        yield None
        return
    with _Watchdog(timeout_s, what, abort) as w:
        yield w
