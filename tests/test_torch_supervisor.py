"""Port: fisr_tpu_torch.utils.supervisor, the restart-on-exit-86 recovery
loop (pairs with utils.watchdog); the cases of tests/test_supervisor.py.

The contract under test: a training child that watchdog-aborts (exit 86)
is restarted until it resumes past the wedge; real failures (nonzero
exits) and the restart budget stop the loop. End-to-end subprocess check
uses a sentinel file as the 'checkpoint' the child resumes from —
mirroring how fit(resume=True) re-derives (epoch, batch) after a restart.
"""

import pathlib
import subprocess
import sys

import pytest

REPO_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)

from fisr_tpu.utils.supervisor import WATCHDOG_EXIT as JAX_WATCHDOG_EXIT
from fisr_tpu_torch.utils.supervisor import WATCHDOG_EXIT, main, supervise
from fisr_tpu_torch.utils.watchdog import EXIT_CODE


def test_watchdog_exit_code_is_shared_contract():
    assert WATCHDOG_EXIT == EXIT_CODE == JAX_WATCHDOG_EXIT == 86


def _child(tmp_path, body: str):
    """A tiny script the supervisor runs; `state` file = its checkpoint."""
    script = tmp_path / "child.py"
    script.write_text(
        "import pathlib, sys\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"  # children import fisr_tpu_torch
        f"state = pathlib.Path({str(tmp_path / 'state')!r})\n" + body)
    return [sys.executable, str(script)]


def test_restarts_on_86_until_child_succeeds(tmp_path):
    # wedges (exit 86) twice, then 'resumes from checkpoint' and finishes
    cmd = _child(tmp_path, (
        "n = int(state.read_text()) if state.exists() else 0\n"
        "state.write_text(str(n + 1))\n"
        "sys.exit(86 if n < 2 else 0)\n"))
    res = supervise(cmd, max_restarts=5, backoff_s=0.01, log=lambda m: None)
    assert res.ok and res.returncode == 0
    assert res.restarts == 2
    assert res.history == [86, 86, 0]


def test_real_failure_is_not_restarted(tmp_path):
    cmd = _child(tmp_path, "state.write_text('ran')\nsys.exit(3)\n")
    res = supervise(cmd, max_restarts=5, backoff_s=0.01, log=lambda m: None)
    assert res.returncode == 3 and res.restarts == 0 and res.history == [3]


def test_restart_budget_bounds_the_loop(tmp_path):
    cmd = _child(tmp_path, "sys.exit(86)\n")  # wedges forever
    res = supervise(cmd, max_restarts=3, backoff_s=0.01, log=lambda m: None)
    assert res.returncode == 86
    assert res.restarts == 3 and res.history == [86, 86, 86, 86]


def test_signal_death_needs_opt_in(tmp_path):
    # SIGKILL-yourself child: rc < 0 from the supervisor's perspective
    cmd = _child(tmp_path, (
        "import os, signal\n"
        "if state.exists(): sys.exit(0)\n"
        "state.write_text('x')\n"
        "os.kill(os.getpid(), signal.SIGKILL)\n"))
    res = supervise(cmd, max_restarts=5, backoff_s=0.01, log=lambda m: None)
    assert res.returncode < 0 and res.restarts == 0  # default: no restart

    (tmp_path / "state").unlink()
    res = supervise(cmd, max_restarts=5, backoff_s=0.01,
                    restart_on_crash=True, log=lambda m: None)
    assert res.ok and res.restarts == 1


def test_backoff_doubles_and_resets_after_healthy_run(tmp_path):
    sleeps = []
    cmd = _child(tmp_path, (
        "n = int(state.read_text()) if state.exists() else 0\n"
        "state.write_text(str(n + 1))\n"
        "sys.exit(86 if n < 3 else 0)\n"))
    # healthy_s=0: every run counts as healthy -> delay resets each time
    res = supervise(cmd, max_restarts=5, backoff_s=0.5, healthy_s=0.0,
                    log=lambda m: None, _sleep=sleeps.append)
    assert res.ok and sleeps == [0.5, 0.5, 0.5]

    (tmp_path / "state").unlink()
    sleeps.clear()  # huge healthy_s: no run is 'healthy' -> doubling
    res = supervise(cmd, max_restarts=5, backoff_s=0.5, healthy_s=1e9,
                    log=lambda m: None, _sleep=sleeps.append)
    assert res.ok and sleeps == [0.5, 1.0, 2.0]


def test_rejects_negative_budget():
    with pytest.raises(ValueError):
        supervise(["true"], max_restarts=-1)


def test_cli_main_end_to_end(tmp_path, capsys):
    """python -m fisr_tpu_torch.utils.supervisor -- <cmd>: the documented entry."""
    cmd = _child(tmp_path, (
        "n = int(state.read_text()) if state.exists() else 0\n"
        "state.write_text(str(n + 1))\n"
        "sys.exit(86 if n < 1 else 0)\n"))
    rc = main(["--max-restarts", "3", "--backoff-s", "0.01", "--"] + cmd)
    assert rc == 0
    out = capsys.readouterr().out
    assert "restart 1/3" in out and "after 1 restart" in out


def test_cli_requires_a_command():
    with pytest.raises(SystemExit):
        main(["--max-restarts", "2"])


def test_supervised_watchdog_abort_resumes_for_real(tmp_path):
    """Full loop in one subprocess tree: child arms a real Heartbeat, run 0
    wedges (never beats) -> watchdog exits 86 -> supervisor restarts ->
    run 1 finds its 'checkpoint' and completes. This is the unattended
    recovery path that training under the supervisor relies on."""
    child = _child(tmp_path, (
        "import time\n"
        "from fisr_tpu_torch.utils.watchdog import Heartbeat\n"
        "hb = Heartbeat(0.4, name='sup-e2e', poll_s=0.05).start()\n"
        "if not state.exists():\n"
        "    state.write_text('ckpt')\n"
        "    time.sleep(30)\n"  # wedged: never beats
        "hb.beat(); hb.stop()\n"))
    sup = subprocess.run(
        [sys.executable, "-m", "fisr_tpu_torch.utils.supervisor",
         "--max-restarts", "2", "--backoff-s", "0.01", "--"] + child,
        capture_output=True, text=True, timeout=60, cwd=REPO_ROOT)
    assert sup.returncode == 0, (sup.returncode, sup.stderr[-500:])
    assert "watchdog abort" in sup.stdout
    assert "no heartbeat" in sup.stderr  # the child's watchdog message
