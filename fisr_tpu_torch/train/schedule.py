"""Learning-rate schedules (port of fisr_tpu/train/schedule.py).

FISRnet schedules (main.py:67-73, FISRnet.py:232-248, 636-638):
  * stair_decay  - piecewise constant: lr * factor**k after epoch boundary k
  * linear_decay - init until the `decay_point` epoch, then linear to 0 at
                   the final epoch, as a function of the global step
  * no_decay

PWC-Net schedules (model_base.py:307-334):
  * multisteps  - piecewise constant on the global step (long and fine
                  variants are different boundary lists, given by the caller)
  * cyclic      - triangular cyclic between base and max bounds

Each returns a plain function of an integer step that returns a Python
float; `train/trainer.TFAdam` calls it on the host once a step. The JAX
package evaluates the same expressions in float32 on the device, so the two
agree to float32 rounding (rtol 1e-6), not bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["stair_decay", "linear_decay", "no_decay", "multisteps", "cyclic"]

Schedule = Callable[[int], float]


def _passed(step: int, bounds: Sequence[int]) -> int:
    # tf.train.piecewise_constant keeps the LEFT value AT a boundary step and
    # switches at step > boundary (pinned by tests/fixtures/tf_oracle/schedule.npz)
    return sum(1 for b in bounds if step > b)


def stair_decay(init_lr: float, boundaries_steps: Sequence[int], factor: float) -> Schedule:
    bounds = list(boundaries_steps)

    def schedule(step: int) -> float:
        return init_lr * factor ** _passed(step, bounds)

    return schedule


def linear_decay(init_lr: float, total_epochs: int, decay_point_epoch: int,
                 steps_per_epoch: int) -> Schedule:
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch  # the integer epoch, as the reference's loop
        if epoch < decay_point_epoch:
            return float(init_lr)
        return init_lr * ((total_epochs - epoch) / float(total_epochs - decay_point_epoch))

    return schedule


def no_decay(init_lr: float) -> Schedule:
    def schedule(step: int) -> float:
        del step
        return float(init_lr)

    return schedule


def multisteps(lr_values: Sequence[float], boundaries: Sequence[int]) -> Schedule:
    """lr_values has len(boundaries)+1 entries (model_pwcnet.py:67-68)."""
    vals, bounds = [float(v) for v in lr_values], list(boundaries)
    if len(vals) != len(bounds) + 1:
        raise ValueError(f"{len(vals)} lr values for {len(bounds)} boundaries")

    def schedule(step: int) -> float:
        return vals[_passed(step, bounds)]

    return schedule


def cyclic(base_lr: float, max_lr: float, stepsize: int) -> Schedule:
    """Triangular cyclic lr (Smith 2015; model_base.py lr_cyclic_*)."""

    def schedule(step: int) -> float:
        cycle = math.floor(1.0 + step / (2.0 * stepsize))
        x = abs(step / float(stepsize) - 2.0 * cycle + 1.0)
        return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x)

    return schedule
