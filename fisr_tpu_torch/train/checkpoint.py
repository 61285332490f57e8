"""Checkpointing: step-keyed saves, resume math, and best-k retention (port
of fisr_tpu/train/checkpoint.py).

Replaces two reference mechanisms:
* FISRnet's `tf.train.Saver(max_to_keep=1)` + per-epoch save keyed on the
  global step, with resume deriving (epoch, batch) from the step counter
  (FISRnet.py:585,742-743,1092-1115);
* tfoptflow's `ckpt_mgr.BestCheckpointSaver`: top-k checkpoints ranked by a
  validation metric with a JSON ledger (model_base.py:115-191).

The directory layout is the JAX package's (`step_<N>/`, `ledger.json`); the
storage is not. The JAX package writes each step with orbax; here a step is
one `step_<N>/tree.npz` whose keys are the '/'-joined key paths of the tree
in the JAX layout (`params/level_1/enc/level_0/conv_in/w`,
`opt_state/mu/...`, `opt_state/nu/...`, `opt_state/count`, `step`), the format
`convert/params.tree_from_npz` reads. A step is written under a temporary
name and renamed, so an interrupted save never shows as the latest step.

`restore` also reads the steps that the JAX package's orbax manager wrote
(through convert/orbax_read.py, without tensorstore), so a directory of
either package restores here; writing stays `tree.npz`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np

from fisr_tpu_torch.convert.orbax_read import is_orbax_step, read_orbax_tree
from fisr_tpu_torch.convert.params import flatten_tree, tree_from_npz

__all__ = ["CheckpointManager", "derive_epoch_batch"]

TREE_FILE = "tree.npz"


def derive_epoch_batch(step: int, iters_per_epoch: int) -> Tuple[int, int]:
    """Resume bookkeeping (FISRnet.py:596-606)."""
    epoch = step // iters_per_epoch
    return epoch, step - epoch * iters_per_epoch


class CheckpointManager:
    """Step-keyed tree checkpoints with optional best-k retention."""

    def __init__(self, directory: str, max_to_keep: int = 1,
                 best_mode: Optional[str] = None):
        """best_mode: None (keep latest max_to_keep), 'min' or 'max' (keep
        the best max_to_keep ranked by the recorded metric)."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode
        self._ledger_path = os.path.join(self.directory, "ledger.json")

    # -- ledger -------------------------------------------------------------
    def _read_ledger(self) -> dict:
        if os.path.exists(self._ledger_path):
            with open(self._ledger_path) as f:
                return json.load(f)
        return {"entries": []}

    def _write_ledger(self, ledger: dict) -> None:
        with open(self._ledger_path, "w") as f:
            json.dump(ledger, f, indent=1)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # -- API ----------------------------------------------------------------
    def save(self, step: int, tree: Any, metric: Optional[float] = None) -> None:
        """tree: nested dict of arrays (numpy, or anything np.asarray takes)."""
        path = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp_step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = {"/".join(p): np.asarray(v) for p, v in flatten_tree(tree)}
        np.savez(os.path.join(tmp, TREE_FILE), **flat)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        ledger = self._read_ledger()
        ledger["entries"] = [e for e in ledger["entries"] if e["step"] != step]
        ledger["entries"].append({"step": step, "metric": metric})
        # retention
        entries = ledger["entries"]
        if self.best_mode and all(e["metric"] is not None for e in entries):
            reverse = self.best_mode == "max"
            entries.sort(key=lambda e: e["metric"], reverse=reverse)
        else:
            entries.sort(key=lambda e: e["step"])
        keep = entries[-self.max_to_keep:] if not self.best_mode else entries[: self.max_to_keep]
        drop = [e for e in entries if e not in keep]
        for e in drop:
            p = self._step_dir(e["step"])
            if os.path.exists(p):
                shutil.rmtree(p)
        ledger["entries"] = sorted(keep, key=lambda e: e["step"])
        self._write_ledger(ledger)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        ledger = self._read_ledger()
        entries = [e for e in ledger["entries"] if e["metric"] is not None]
        if not entries:
            return self.latest_step()
        key = min if self.best_mode != "max" else max
        return key(entries, key=lambda e: e["metric"])["step"]

    def restore(self, step: Optional[int] = None, item: Any = None) -> Any:
        """The saved tree as nested dicts (and lists) of numpy arrays: a step
        of this package (`tree.npz`) or of the JAX package's orbax manager.
        With `item`, a template tree, the result has its structure: the same
        keys, each leaf's shape checked and cast to the template leaf's
        dtype, as orbax restores into an item."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        if os.path.exists(os.path.join(path, TREE_FILE)):
            tree = tree_from_npz(os.path.join(path, TREE_FILE))
        elif is_orbax_step(path):
            tree = read_orbax_tree(path)
        else:
            raise FileNotFoundError(
                f"{path} holds neither {TREE_FILE} (this package's checkpoints) nor _METADATA "
                "and manifest.ocdbt (the JAX package's orbax checkpoints)")
        return tree if item is None else _restore_into(item, tree, ())


def _restore_into(template: Any, tree: Any, path: tuple) -> Any:
    """`tree` in the structure, shapes and dtypes of `template`."""
    where = "/".join(map(str, path)) or "the root"
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise KeyError(f"checkpoint at {where}: a {type(tree).__name__} where the template "
                           "has a dict")
        if set(tree) != set(template):
            raise KeyError(f"checkpoint at {where}: missing {sorted(set(template) - set(tree))}, "
                           f"unexpected {sorted(set(tree) - set(template))}")
        return {k: _restore_into(v, tree[k], path + (k,)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise KeyError(f"checkpoint at {where}: not a sequence of {len(template)} items "
                           "as in the template")
        return type(template)(_restore_into(t, v, path + (i,))
                              for i, (t, v) in enumerate(zip(template, tree)))
    want = np.asarray(template)
    got = np.asarray(tree)
    if got.shape != want.shape:
        raise ValueError(f"checkpoint at {where}: shape {got.shape} != template's {want.shape}")
    return got.astype(want.dtype)
