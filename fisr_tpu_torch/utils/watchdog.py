"""Step-heartbeat watchdog: turn a silent hang into a fast, resumable crash
(copy of fisr_tpu/utils/watchdog.py; standard library only).

Motivation (observed on the JAX package's stack, 2026-08-19): a training
run wedged mid-epoch on a device-runtime RPC that never returned — the
Python thread was blocked inside a C extension, CPU time frozen, no
exception, no log output, for 49 minutes until an external monitor killed
it. Python-level remedies (signals, KeyboardInterrupt, thread exceptions)
cannot interrupt a thread blocked in native code, so the only reliable
in-process defense is a monitor thread that notices the heartbeat stopped
and hard-exits the process; a supervisor then restarts it and training
resumes from the last per-epoch checkpoint (train/loop.py `fit(resume=True)`
re-derives (epoch, batch) from the restored step).

The reference has no analog — its posture is checkpoint/resume only
(FISRnet.py:580-744 trains until killed by hand). This module is the
"failure detection" half that makes the existing "recovery" half
(train/checkpoint.py) reachable without a human noticing the stall.

Design rules:
  * `os._exit(exit_code)` — not `sys.exit` — because atexit handlers and
    daemon-thread joins can themselves block on the wedged runtime.
  * Before exiting, dump all thread stacks via `faulthandler` so the
    post-mortem shows WHERE the process was stuck (the one diagnostic the
    49-minute silent hang denied us).
  * The monitor is a daemon thread: it never keeps a healthy process alive.
  * EXIT_CODE 86 distinguishes a watchdog abort from a crash (139/134) or
    a clean exit, so supervisors can choose restart policy per cause.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["Heartbeat", "EXIT_CODE"]

EXIT_CODE = 86  # distinct "watchdog abort" status for supervisors


class Heartbeat:
    """Monitor that hard-exits the process if `beat()` stops arriving.

    Usage (training loop)::

        hb = Heartbeat(timeout_s=300, name="train")
        with hb:
            for batch in batches:
                state, m = step_fn(state, batch)
                hb.beat()

    `timeout_s` must comfortably exceed the slowest *legitimate* gap
    between beats — include the first call's kernel build and cuDNN
    autotuning plus a stall margin; per-step beats with a 5-minute
    timeout is a good default for this stack.

    Parameters
    ----------
    timeout_s: seconds of beat silence before the process is aborted.
    name: tag used in the abort message.
    on_timeout: optional callable invoked INSTEAD of the default
        dump-stacks-and-`os._exit` action (used by tests, or to flush a
        checkpoint ledger first — keep it non-blocking: it runs on the
        monitor thread while the main thread may be wedged).
    exit_code: process exit status for the default action.
    poll_s: monitor wake interval; defaults to timeout_s/4 capped at 15 s.
    """

    def __init__(self, timeout_s: float, name: str = "heartbeat",
                 on_timeout: Optional[Callable[[float], None]] = None,
                 exit_code: int = EXIT_CODE,
                 poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.name = name
        self.exit_code = exit_code
        self._on_timeout = on_timeout
        self._poll_s = float(poll_s) if poll_s else min(timeout_s / 4.0, 15.0)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Heartbeat":
        if self._thread is not None:
            raise RuntimeError("Heartbeat already started")
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"watchdog:{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Disarm. Safe to call multiple times / without start()."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self._poll_s + 1.0)
        self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the two operations ------------------------------------------------
    def beat(self) -> None:
        """Record liveness. Cheap (one clock read + one store)."""
        self._last = time.monotonic()

    @property
    def seconds_since_beat(self) -> float:
        return time.monotonic() - self._last

    # -- monitor -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            silent = time.monotonic() - self._last
            if silent > self.timeout_s:
                if self._on_timeout is not None:
                    try:
                        self._on_timeout(silent)
                    finally:
                        return
                self._abort(silent)
                return

    def _abort(self, silent: float) -> None:
        msg = (f"[watchdog:{self.name}] no heartbeat for {silent:.0f} s "
               f"(timeout {self.timeout_s:.0f} s) — dumping stacks and "
               f"exiting {self.exit_code} so the supervisor can restart "
               f"from the last checkpoint\n")
        try:
            sys.stderr.write(msg)
            # show where every thread is stuck (incl. the wedged one)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
        except Exception:
            pass  # diagnostics must never block the abort
        os._exit(self.exit_code)
