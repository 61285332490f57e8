"""Weights across frameworks: JAX param trees, TF variable dicts and .npz
files -> the port's modules.

The JAX package keeps params as nested dicts whose key paths are the TF
variable scopes; the port's submodule names follow the same paths, so the
conversion is a rename plus one layout permute for every 4-D kernel:
conv HWIO [k, k, in, out] -> OIHW [out, in, k, k], and TF conv2d_transpose
[k, k, out, in] -> torch conv_transpose2d [in, out, k, k]. Both are
`transpose(3, 2, 0, 1)`.

Training state crosses the same way: the JAX package's ScaleByAdamState
(`count`, `mu`, `nu`; the moments are trees shaped like the params) <-> the
state of `train/trainer.TFAdam`, the moments permuted like their kernels.
`train_state_tree` is what a checkpoint of the port stores, and is the JAX
package's {"params", "opt_state", "step"} tree as numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from fisr_tpu_torch.convert.oracle import deterministic_tf_vars
from fisr_tpu_torch.models.fisrnet import FISRnet
from fisr_tpu_torch.models.pwcnet import PWCNet, PWCNetConfig

__all__ = ["fisrnet_name_map", "pwcnet_name_map", "fisrnet_from_jax",
           "pwcnet_from_jax", "from_tf_vars", "to_jax_tree", "tree_from_npz",
           "flatten_tree", "deterministic_fisrnet", "deterministic_pwcnet",
           "adam_state_to_jax", "load_adam_state_", "train_state_tree",
           "load_train_state_"]

_LEAF_TO_TORCH = {"w": "weight", "b": "bias"}
_LEAF_TO_JAX = {"weight": "w", "bias": "b"}


def _conv_entries(tf_prefix: str, path: tuple, names=("w", "b")) -> Dict[str, tuple]:
    return {f"{tf_prefix}/{names[0]}": path + ("w",),
            f"{tf_prefix}/{names[1]}": path + ("b",)}


def _res_entries(tf_prefix: str, path: tuple, names=("w", "b")) -> Dict[str, tuple]:
    out = {}
    out.update(_conv_entries(f"{tf_prefix}/conv/0", path + ("conv0",), names))
    out.update(_conv_entries(f"{tf_prefix}/conv/1", path + ("conv1",), names))
    return out


def fisrnet_name_map() -> Dict[str, tuple]:
    """{tf_var_name: key path} for the 276 FISRnet variables."""
    m: Dict[str, tuple] = {}
    for lvl in (1, 2, 3):
        base = f"FISRnet/level_{lvl}"
        p = (f"level_{lvl}",)
        for k in (0, 1, 2):
            ep = p + ("enc", f"level_{k}")
            m.update(_conv_entries(f"{base}/enc/level_{k}/conv/0", ep + ("conv_in",)))
            m.update(_res_entries(f"{base}/enc/level_{k}/res_block/0", ep + ("res0",)))
            m.update(_res_entries(f"{base}/enc/level_{k}/res_block/1", ep + ("res1",)))
        bp = p + ("bottleneck",)
        m.update(_conv_entries(f"{base}/bottleneck/conv/0", bp + ("conv_in",)))
        m.update(_res_entries(f"{base}/bottleneck/res_block/0", bp + ("res0",)))
        for k in (2, 1, 0):
            dp = p + ("dec", f"level_{k}")
            m.update(_conv_entries(f"{base}/dec/level_{k}/resize", dp + ("resize",)))
            m.update(_conv_entries(f"{base}/dec/level_{k}/conv/0", dp + ("conv_in",)))
            m.update(_res_entries(f"{base}/dec/level_{k}/res_block/0", dp + ("res0",)))
            m.update(_res_entries(f"{base}/dec/level_{k}/res_block/1", dp + ("res1",)))
        for tf_head, our_head in (("FI-SR", "fisr"), ("SR", "sr")):
            hp = p + (our_head,)
            m.update(_conv_entries(f"{base}/{tf_head}/conv/0", hp + ("conv0",)))
            m.update(_res_entries(f"{base}/{tf_head}/res_block/0", hp + ("res0",)))
            m.update(_conv_entries(f"{base}/{tf_head}/conv/1", hp + ("conv1",)))
            m.update(_conv_entries(f"{base}/{tf_head}/conv/2", hp + ("conv2",)))
    return m


def pwcnet_name_map(pyr_lvls: int = 6, flow_pred_lvl: int = 2,
                    use_res_cx: bool = True) -> Dict[str, tuple]:
    kb = ("kernel", "bias")
    m: Dict[str, tuple] = {}
    for lvl in range(1, pyr_lvls + 1):
        fp = ("feat", f"level_{lvl}")
        m.update(_conv_entries(f"pwcnet/featpyr/conv{lvl}a", fp + ("a",), kb))
        m.update(_conv_entries(f"pwcnet/featpyr/conv{lvl}aa", fp + ("aa",), kb))
        m.update(_conv_entries(f"pwcnet/featpyr/conv{lvl}b", fp + ("b",), kb))
    for lvl in range(pyr_lvls, flow_pred_lvl - 1, -1):
        lp = ("flow", f"level_{lvl}")
        for i in range(5):
            m.update(_conv_entries(f"pwcnet/predict_flow/conv{lvl}_{i}",
                                   lp + (f"conv{i}",), kb))
        m.update(_conv_entries(f"pwcnet/predict_flow/flow{lvl}", lp + ("pred",), kb))
        if use_res_cx or lvl == flow_pred_lvl:
            cp = ("ctx", f"level_{lvl}")
            for i in range(1, 8):
                m.update(_conv_entries(f"pwcnet/ctxt/dc_conv{lvl}{i}",
                                       cp + (f"dc{i}",), kb))
        if lvl != flow_pred_lvl:
            up = ("up", f"level_{lvl}")
            m.update(_conv_entries(f"pwcnet/upsample/up_flow{lvl}", up + ("flow",), kb))
            m.update(_conv_entries(f"pwcnet/upsample/up_feat{lvl}", up + ("feat",), kb))
    return m


def flatten_tree(tree, prefix=()):
    """(key path, leaf) pairs of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_path(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _torch_items(tree: dict) -> Dict[str, torch.Tensor]:
    """A tree in the JAX layout as {torch parameter name: tensor}."""
    state = {}
    for path, arr in flatten_tree(tree):
        a = np.asarray(arr, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        state[".".join(path[:-1] + (_LEAF_TO_TORCH[path[-1]],))] = torch.from_numpy(
            np.array(a, order="C"))
    return state


def _jax_tree(named_tensors) -> dict:
    """(torch parameter name, tensor) pairs as a tree in the JAX layout."""
    tree: dict = {}
    for key, t in named_tensors:
        a = t.detach().cpu().float().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        parts = key.split(".")
        _set_path(tree, tuple(parts[:-1]) + (_LEAF_TO_JAX[parts[-1]],), np.ascontiguousarray(a))
    return tree


def _load_tree_(model: nn.Module, tree: dict) -> nn.Module:
    state = _torch_items(tree)
    want = model.state_dict()
    if set(state) != set(want):
        missing = sorted(set(want) - set(state))[:3]
        extra = sorted(set(state) - set(want))[:3]
        raise KeyError(f"param tree does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    for k, v in state.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{k}: shape {tuple(v.shape)} != model's {tuple(want[k].shape)}")
    model.load_state_dict(state)
    return model


def fisrnet_from_jax(tree: dict, sf: int = 2, device="cuda") -> FISRnet:
    """FISRnet from the JAX package's param tree (nested dict of arrays);
    widths are read from the tree."""
    w0 = np.asarray(tree["level_1"]["enc"]["level_0"]["conv_in"]["w"])
    model = FISRnet(in_ch=w0.shape[2], sf=sf, ch=w0.shape[3], device=device)
    return _load_tree_(model, tree)


def pwcnet_from_jax(tree: dict, cfg: PWCNetConfig = PWCNetConfig(), device="cuda") -> PWCNet:
    """PWC-Net from the JAX package's param tree under `cfg`."""
    return _load_tree_(PWCNet(cfg, device=device), tree)


def from_tf_vars(tf_vars: Dict[str, np.ndarray], model: str,
                 cfg: PWCNetConfig = PWCNetConfig(), device="cuda"):
    """{tf_variable_name: array} -> the port's 'fisrnet' or 'pwcnet' module."""
    if model == "fisrnet":
        name_map = fisrnet_name_map()
    elif model == "pwcnet":
        name_map = pwcnet_name_map(cfg.pyr_lvls, cfg.flow_pred_lvl, cfg.use_res_cx)
    else:
        raise ValueError(f"unknown model {model!r}")
    missing = [k for k in name_map if k not in tf_vars]
    if missing:
        raise KeyError(f"{len(missing)} variables missing, e.g. {missing[:3]}")
    tree: dict = {}
    for name, path in name_map.items():
        _set_path(tree, path, tf_vars[name])
    if model == "fisrnet":
        return fisrnet_from_jax(tree, device=device)
    return pwcnet_from_jax(tree, cfg, device=device)


def to_jax_tree(model: nn.Module) -> dict:
    """The module's weights as the JAX package's nested dict, JAX layouts."""
    return _jax_tree(model.state_dict().items())


def tree_from_npz(path: str) -> dict:
    """Nested param tree from an .npz of '/'-joined key paths -> arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for k in z.files:
            _set_path(tree, tuple(k.split("/")), z[k])
    return tree


def _tf_shapes(model: nn.Module, name_map: Dict[str, tuple]) -> Dict[str, tuple]:
    flat = dict(flatten_tree(to_jax_tree(model)))
    return {name: flat[path].shape for name, path in name_map.items()}


def deterministic_fisrnet(ch: int = 64, device="cuda") -> FISRnet:
    """FISRnet on the TF-oracle generator's weights (full width at ch=64)."""
    shapes = _tf_shapes(FISRnet(ch=ch, device="cpu"), fisrnet_name_map())
    return from_tf_vars(deterministic_tf_vars(shapes), "fisrnet", device=device)


def deterministic_pwcnet(cfg: PWCNetConfig = PWCNetConfig(), device="cuda") -> PWCNet:
    """PWC-Net on the TF-oracle generator's weights under `cfg`."""
    name_map = pwcnet_name_map(cfg.pyr_lvls, cfg.flow_pred_lvl, cfg.use_res_cx)
    shapes = _tf_shapes(PWCNet(cfg, device="cpu"), name_map)
    return from_tf_vars(deterministic_tf_vars(shapes), "pwcnet", cfg, device=device)


def adam_state_to_jax(model: nn.Module, optimizer) -> dict:
    """The TFAdam state over `model`'s parameters as the fields of the JAX
    package's ScaleByAdamState: {"count": int32, "mu": tree, "nu": tree}."""
    named = list(model.named_parameters())
    return {"count": np.asarray(optimizer.count, np.int32),
            "mu": _jax_tree((k, optimizer.state[p]["mu"]) for k, p in named),
            "nu": _jax_tree((k, optimizer.state[p]["nu"]) for k, p in named)}


def load_adam_state_(model: nn.Module, optimizer, adam_state) -> None:
    """A ScaleByAdamState (the named tuple with numpy or JAX leaves, or a
    mapping with its fields) into the TFAdam over `model`'s parameters."""
    s = adam_state._asdict() if hasattr(adam_state, "_asdict") else adam_state
    named = dict(model.named_parameters())
    for field in ("mu", "nu"):
        items = _torch_items(s[field])
        if set(items) != set(named):
            raise KeyError(f"optimizer state {field!r} does not match the model's parameters")
        with torch.no_grad():
            for k, v in items.items():
                optimizer.state[named[k]][field].copy_(v)
    optimizer.count = int(np.asarray(s["count"]))


def train_state_tree(model: nn.Module, optimizer, step: int) -> dict:
    """What a checkpoint stores: the JAX package's TrainState as numpy."""
    return {"params": to_jax_tree(model), "opt_state": adam_state_to_jax(model, optimizer),
            "step": np.asarray(step, np.int32)}


def load_train_state_(model: nn.Module, optimizer, tree: dict) -> int:
    """`train_state_tree`'s inverse, in place; returns the step."""
    _load_tree_(model, tree["params"])
    load_adam_state_(model, optimizer, tree["opt_state"])
    return int(np.asarray(tree["step"]))
