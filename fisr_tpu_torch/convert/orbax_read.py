"""Read a checkpoint step written by the JAX package's orbax
`CheckpointManager` (fisr_tpu/train/checkpoint.py) without JAX, orbax,
tensorstore or a zstd library.

A step directory (`step_<N>/`) of orbax's PyTreeCheckpointer holds:

  _METADATA          JSON: `tree_metadata` maps each leaf to its key path
                     (`key_metadata`: key and key_type, 1 = a sequence
                     index, 2 = a dict key) and its `value_metadata`
                     (`value_type` np.ndarray, jax.Array or scalar)
  manifest.ocdbt,    an OCDBT key-value store (convert/ocdbt.py) holding one
  d/, ocdbt.process_0/  zarr v2 array a leaf, named by the key path joined
                     with '.', its chunks zstd-compressed

Writers may add `_CHECKPOINT_METADATA`, `_sharding` and `array_metadatas/`;
the read needs none of them. The zarr arrays are read here (`read_zarr_arrays`)
and their chunks decoded by the host runtime's zstd decoder (csrc/zstd.cc),
all of a step's chunks in one batch on the host's cores.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["read_orbax_tree", "is_orbax_step", "read_zarr_arrays", "tree_digest"]

_READ_TYPES = ("np.ndarray", "jax.Array", "scalar")
_SEQUENCE_KEY, _DICT_KEY = 1, 2
# zarr v2 dtypes read here; "bfloat16" is tensorstore's name for ml_dtypes'
_DTYPES = ("<f4", "<f8", "<f2", "<i4", "<i8", "<u1", "|b1", "bfloat16")
_FILLS = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}


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


def _dtype(name: str, where: str) -> np.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(f"{where}: zarr dtype {name!r} (this reader takes {_DTYPES})")
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _zarray(meta: dict, where: str) -> tuple:
    """A .zarray's (shape, chunks, dtype, fill value, compressed, key
    separator), each field checked against what this reader takes."""
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"{where}: zarr_format {meta.get('zarr_format')!r}")
    if meta.get("order", "C") != "C":
        raise NotImplementedError(f"{where}: order {meta['order']!r} (only C)")
    if meta.get("filters"):
        raise NotImplementedError(f"{where}: filters {meta['filters']!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise NotImplementedError(f"{where}: compressor {comp.get('id')!r} (only zstd or none)")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise NotImplementedError(f"{where}: dimension_separator {sep!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{where}: chunks {list(chunks)} for shape {list(shape)}")
    dtype = _dtype(meta["dtype"], where)
    fill = meta.get("fill_value")
    fill = 0 if fill is None else _FILLS.get(fill, fill)
    return shape, chunks, dtype, fill, comp is not None, sep


def read_zarr_arrays(store, names) -> list:
    """The zarr v2 arrays `names` of an OcdbtStore as numpy arrays (a
    scalar as a 0-d array): a regular chunk grid in C order, edge chunks
    stored full size and cropped, a missing chunk filled with fill_value
    (0 for null); every zstd chunk decoded in one batch."""
    from fisr_tpu_torch import native

    plans, frames, sizes = [], [], []
    for name in names:
        where = f"{store.root}: array {name}"
        raw = store.read(f"{name}/.zarray")
        if raw is None:
            if store.read(f"{name}/zarr.json") is not None:
                raise NotImplementedError(f"{where}: a zarr v3 array (zarr.json)")
            raise FileNotFoundError(f"{where}: no {name}/.zarray in the store")
        shape, chunks, dtype, fill, compressed, sep = _zarray(json.loads(raw), where)
        grid = [-(-n // c) for n, c in zip(shape, chunks)]
        nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
        parts = []
        for idx in np.ndindex(*grid):
            key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
            data = store.read(key)
            if data is None:
                continue  # never written: the fill value
            if not compressed and len(data) != nbytes:
                raise ValueError(f"{where}: chunk {key} holds {len(data)} bytes, not {nbytes}")
            parts.append((idx, len(frames) if compressed else np.frombuffer(bytearray(data),
                                                                            np.uint8)))
            if compressed:
                frames.append(data)
                sizes.append(nbytes)
        plans.append((shape, chunks, dtype, fill, parts))
    try:
        decoded = native.zstd_decompress_batch(frames, sizes)
    except ValueError as e:
        raise ValueError(f"{store.root}: {e}") from None
    arrays = []
    for shape, chunks, dtype, fill, parts in plans:
        chunk = [(decoded[p] if isinstance(p, int) else p).view(dtype).reshape(chunks)
                 for _, p in parts]
        out = np.full(shape, fill, dtype)
        for (idx, _), c in zip(parts, chunk):
            dst = tuple(slice(i * k, min((i + 1) * k, n)) for i, k, n in zip(idx, chunks, shape))
            out[dst] = c[tuple(slice(0, d.stop - d.start) for d in dst)]
        arrays.append(out)
    return arrays


def read_orbax_tree(step_dir: str) -> dict:
    """Every leaf of an orbax step directory as numpy arrays of the stored
    dtype and shape (a scalar leaf as a 0-d array), nested by the key paths
    that `_METADATA` names."""
    from fisr_tpu_torch.convert.ocdbt import OcdbtStore

    step_dir = os.path.abspath(step_dir)
    if not is_orbax_step(step_dir):
        raise FileNotFoundError(f"{step_dir}: no _METADATA and manifest.ocdbt, "
                                "not an orbax checkpoint step")
    with open(os.path.join(step_dir, "_METADATA")) as f:
        tree_meta = json.load(f)["tree_metadata"]
    keys, names = [], []
    for entry in tree_meta.values():
        keys.append(entry["key_metadata"])
        names.append(".".join(str(k["key"]) for k in keys[-1]))
        kind = entry["value_metadata"]["value_type"]
        if kind not in _READ_TYPES:
            raise ValueError(f"{step_dir}: leaf {names[-1]} has value_type {kind!r}, "
                             f"not one of {_READ_TYPES}")
    arrays = read_zarr_arrays(OcdbtStore(step_dir), names)
    return _nest(list(zip(keys, arrays)))


def tree_digest(tree) -> str:
    """SHA-256 over a tree's leaves in sorted key-path order: each leaf's
    '/'-joined key path, dtype name, shape and C-order bytes."""
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            leaves.append(("/".join(path), np.asarray(node)))

    walk(tree, ())
    h = hashlib.sha256()
    for path, a in sorted(leaves, key=lambda kv: kv[0]):
        h.update(f"{path}\0{a.dtype.name}\0{list(a.shape)}\0".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()
