"""Share of training steps that ran as a replay of the step's CUDA graph:
program counters `train.graph_replays` over `train.steps`
(train/pwc_trainer.make_pwc_train_step), over the whole run: the set-up's
eager warm-up and capture, the traced steps and the window. None where the
program counts no steps (as before the graph); 0 where it counts steps and
replays none."""

from fisrbench.harness.program import totals


def read(_reading):
    t = totals()
    steps = t["counters"].get("train.steps") if t is not None else None
    if not steps:
        return None
    return 100.0 * t["counters"].get("train.graph_replays", 0) / steps
