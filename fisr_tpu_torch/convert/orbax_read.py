"""Read a checkpoint step written by the JAX package's orbax
`CheckpointManager` (fisr_tpu/train/checkpoint.py) without JAX or orbax.

A step directory (`step_<N>/`) of orbax's PyTreeCheckpointer holds:

  _METADATA          JSON: `tree_metadata` maps each leaf to its key path
                     (`key_metadata`: key and key_type, 1 = a sequence
                     index, 2 = a dict key) and its `value_metadata`
                     (`value_type` np.ndarray, jax.Array or scalar)
  manifest.ocdbt,    an OCDBT key-value store holding one zarr v2 array a
  d/, ocdbt.process_0/  leaf, named by the key path joined with '.', its
                     chunks zstd-compressed

Writers may add `_CHECKPOINT_METADATA`, `_sharding` and `array_metadatas/`;
the read needs none of them. Decoding OCDBT and zstd needs `tensorstore`
(the library orbax writes with), imported inside `read_orbax_tree`; a machine
without it converts a step elsewhere with
`python -m fisr_tpu_torch.convert.cli --orbax <step_dir> --out <dir>`.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["read_orbax_tree", "is_orbax_step", "ORBAX_ROUTE"]

ORBAX_ROUTE = "python -m fisr_tpu_torch.convert.cli --orbax <step_dir> --out <dir>"
_READ_TYPES = ("np.ndarray", "jax.Array", "scalar")
_SEQUENCE_KEY, _DICT_KEY = 1, 2


def is_orbax_step(step_dir: str) -> bool:
    """Whether `step_dir` looks like an orbax PyTreeCheckpointer step."""
    return all(os.path.exists(os.path.join(step_dir, f))
               for f in ("_METADATA", "manifest.ocdbt"))


def _nest(leaves):
    """(key_metadata, value) pairs -> the nested tree: dict keys as dicts,
    sequence indices as lists (what orbax's restore gives without a
    template)."""
    root: dict = {}
    for keys, value in leaves:
        path = []
        for k in keys:
            if k["key_type"] not in (_SEQUENCE_KEY, _DICT_KEY):
                raise ValueError(f"key {k} has key_type {k['key_type']}, not a dict key or "
                                 "a sequence index")
            path.append(int(k["key"]) if k["key_type"] == _SEQUENCE_KEY else k["key"])
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return _lists(root)


def _lists(node):
    """The dicts keyed by sequence indices (ints; dict keys are strings) as
    lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence with indices {sorted(out)} is not 0..{len(out) - 1}")
        return [out[i] for i in range(len(out))]
    return out


def read_orbax_tree(step_dir: str) -> dict:
    """Every leaf of an orbax step directory as numpy arrays of the stored
    dtype and shape (a scalar leaf as a 0-d array), nested by the key paths
    that `_METADATA` names."""
    step_dir = os.path.abspath(step_dir)
    if not is_orbax_step(step_dir):
        raise FileNotFoundError(f"{step_dir}: no _METADATA and manifest.ocdbt, "
                                "not an orbax checkpoint step")
    try:
        import tensorstore as ts
    except ImportError:
        raise ImportError(
            f"reading the orbax checkpoint {step_dir} needs the tensorstore package, which "
            f"this machine lacks; convert it on a machine that has it with `{ORBAX_ROUTE}` "
            "and restore the converted directory") from None
    with open(os.path.join(step_dir, "_METADATA")) as f:
        tree_meta = json.load(f)["tree_metadata"]
    base = {"driver": "ocdbt", "base": "file://" + step_dir}
    opening = []
    for entry in tree_meta.values():
        keys = entry["key_metadata"]
        name = ".".join(str(k["key"]) for k in keys)
        kind = entry["value_metadata"]["value_type"]
        if kind not in _READ_TYPES:
            raise ValueError(f"{step_dir}: leaf {name} has value_type {kind!r}, "
                             f"not one of {_READ_TYPES}")
        spec = {"driver": "zarr", "kvstore": dict(base, path=name)}
        opening.append((keys, ts.open(spec, open=True, read=True)))
    # every open, then every read, is in flight at once
    reading = [(keys, store.result().read()) for keys, store in opening]
    return _nest([(keys, np.asarray(r.result())) for keys, r in reading])
