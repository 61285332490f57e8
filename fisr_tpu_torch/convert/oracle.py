"""Deterministic weights + digests for cross-framework parity oracles (the
port's own copy of fisr_tpu/convert/oracle.py).

The TF-oracle fixtures (tests/fixtures/tf_oracle/) were captured from the
reference's own TF graphs on weights that any framework can regenerate
bit for bit from the TF variable names alone:

    w[name] = default_rng(crc32(name)).normal(0, glorot * GAIN, shape)

A sha256 digest over the sorted (name, shape, bytes) stream travels with each
fixture, so a generator or shape drift fails loudly.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Dict

import numpy as np

__all__ = ["deterministic_tf_vars", "tf_vars_digest", "GAIN"]

# Damping below the glorot stddev: random FISRnet levels of 15 res blocks
# explode by level 3 otherwise; 0.6 keeps outputs O(1).
GAIN = 0.6


def _glorot_std(shape) -> float:
    if len(shape) == 4:  # HWIO conv kernel
        rf = shape[0] * shape[1]
        fan_in, fan_out = rf * shape[2], rf * shape[3]
    elif len(shape) == 2:
        fan_in, fan_out = shape
    else:  # bias / vector
        fan_in = fan_out = max(int(np.prod(shape)), 1)
    return float(np.sqrt(2.0 / (fan_in + fan_out)))


def deterministic_tf_vars(shapes: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """{tf_var_name: f32 array} generated per name (order-independent).
    Biases get small nonzero values so a dropped +b shows."""
    out = {}
    for name in sorted(shapes):
        shape = tuple(int(s) for s in shapes[name])
        rng = np.random.default_rng(zlib.crc32(name.encode("utf-8")))
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("b", "bias") or len(shape) <= 1:
            arr = rng.normal(0.0, 0.01, shape)
        else:
            arr = rng.normal(0.0, GAIN * _glorot_std(shape), shape)
        out[name] = arr.astype(np.float32)
    return out


def tf_vars_digest(tf_vars: Dict[str, np.ndarray]) -> str:
    """sha256 over the sorted (name, shape, raw f32 bytes) stream."""
    h = hashlib.sha256()
    for name in sorted(tf_vars):
        arr = np.ascontiguousarray(np.asarray(tf_vars[name], np.float32))
        h.update(name.encode("utf-8"))
        h.update(str(arr.shape).encode("utf-8"))
        h.update(arr.tobytes())
    return h.hexdigest()
