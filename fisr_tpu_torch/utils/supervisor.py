"""Restart supervisor: the recovery half that pairs with utils.watchdog
(copy of fisr_tpu/utils/supervisor.py; standard library only).

`watchdog.Heartbeat` turns a silent hang (e.g. a wedged device-runtime
call) into a fast `exit 86`; this module notices that exit and restarts the
command, so training (train/loop.fit, `--phase train`, which resume from the
newest checkpoint) picks up from the last checkpoint with no human in the
loop. Together they complete the failure-detection + recovery subsystem
(SURVEY.md §5): the reference's posture is checkpoint/resume driven by a
person watching the console (FISRnet.py:580-744 trains until killed by
hand); here the whole loop closes unattended.

Policy (deliberately narrow):
  * exit 86 (watchdog abort)  -> always restart: the process declared
    itself wedged-but-resumable.
  * signal deaths (rc < 0, e.g. SIGKILL from the OOM killer) -> restart
    only with `restart_on_crash=True`: the failure may be environmental
    and repeatable, so it is opt-in and bounded the same way.
  * any other nonzero exit -> never restart: a real bug or bad flag would
    loop forever; surface it.
  * `max_restarts` bounds total restarts; `backoff_s` doubles per restart
    (cap 300 s) and resets after a run that stayed healthy > `healthy_s`.

CLI:  python -m fisr_tpu_torch.utils.supervisor [opts] -- cmd arg...
e.g.  python -m fisr_tpu_torch.utils.supervisor --max-restarts 20 -- \\
          python -m fisr_tpu_torch.cli.main --phase train --step_timeout_s 600
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from fisr_tpu_torch.utils.watchdog import EXIT_CODE as WATCHDOG_EXIT

__all__ = ["supervise", "SuperviseResult", "WATCHDOG_EXIT", "main"]


@dataclass
class SuperviseResult:
    """Outcome of a supervised run (the last child's rc + the history)."""
    returncode: int
    restarts: int
    history: List[int] = field(default_factory=list)  # every child rc, in order

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def supervise(
    cmd: Sequence[str],
    *,
    max_restarts: int = 10,
    backoff_s: float = 1.0,
    backoff_cap_s: float = 300.0,
    healthy_s: float = 600.0,
    restart_on_crash: bool = False,
    log=print,
    _sleep=time.sleep,
) -> SuperviseResult:
    """Run `cmd`, restarting it on watchdog aborts (exit 86).

    Returns once the child exits 0, exits with a non-restartable status,
    or the restart budget is spent. `log`/`_sleep` are injectable for
    tests. Backoff doubles per restart but resets to `backoff_s` whenever
    a child stays up longer than `healthy_s` (long-lived training that
    wedges once a day should not inherit yesterday's backoff).
    """
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    history: List[int] = []
    restarts = 0
    delay = backoff_s
    while True:
        t0 = time.monotonic()
        rc = subprocess.call(list(cmd))
        alive_s = time.monotonic() - t0
        history.append(rc)
        if rc == 0:
            return SuperviseResult(rc, restarts, history)
        restartable = (rc == WATCHDOG_EXIT) or (rc < 0 and restart_on_crash)
        if not restartable:
            log(f"[supervisor] child exited {rc} (not restartable) "
                f"after {alive_s:.0f} s — giving up")
            return SuperviseResult(rc, restarts, history)
        if restarts >= max_restarts:
            log(f"[supervisor] child exited {rc} but the restart budget "
                f"({max_restarts}) is spent — giving up")
            return SuperviseResult(rc, restarts, history)
        if alive_s > healthy_s:
            delay = backoff_s  # it ran healthily for a while; fresh slate
        cause = "watchdog abort" if rc == WATCHDOG_EXIT else f"signal {-rc}"
        restarts += 1
        log(f"[supervisor] {cause} after {alive_s:.0f} s — restart "
            f"{restarts}/{max_restarts} in {delay:.0f} s")
        _sleep(delay)
        delay = min(delay * 2.0, backoff_cap_s)


def _parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fisr_tpu_torch.utils.supervisor",
        description="Restart a command on watchdog aborts (exit 86).")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--backoff-s", type=float, default=1.0)
    ap.add_argument("--healthy-s", type=float, default=600.0)
    ap.add_argument("--restart-on-crash", action="store_true",
                    help="also restart on signal deaths (OOM-kill etc.)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to run (everything after --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing command (put it after --)")
    args.cmd = cmd
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    res = supervise(args.cmd, max_restarts=args.max_restarts,
                    backoff_s=args.backoff_s, healthy_s=args.healthy_s,
                    restart_on_crash=args.restart_on_crash)
    if res.restarts:
        print(f"[supervisor] done: rc={res.returncode} "
              f"after {res.restarts} restart(s)")
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
