"""TF1 checkpoint -> param tree in the JAX layout (port of
fisr_tpu/convert/tf_import.py).

The reference ships its weights as TF1 checkpoints (FISRnet-122000 for
FISRnet, pwcnet.ckpt-595000 for the flow model). Conversion is a rename: the
JAX package's trees mirror the TF variable scopes, conv kernels are HWIO on
both sides and deconv kernels keep TF's conv2d_transpose [k, k, OUT, IN]
layout. The name maps are `convert/params.{fisrnet,pwcnet}_name_map`; the
trees these functions give are what `convert/params.{fisrnet,pwcnet}_from_jax`
take to build the port's modules.

`load_tf_checkpoint` is the one call from a TensorBundle prefix to a
validated tree: read the bundle (convert/tensor_bundle.py, no TensorFlow),
drop optimizer slots, rename, and check the key set and every shape against
a fresh module of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from fisr_tpu_torch.convert import params
from fisr_tpu_torch.convert.params import fisrnet_name_map, pwcnet_name_map

__all__ = ["normalize_tf_vars", "convert_fisrnet", "convert_pwcnet", "export_fisrnet",
           "export_pwcnet", "check_tree", "load_tf_checkpoint"]


def normalize_tf_vars(tf_vars: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip ':0' suffixes and drop the optimizer slots and bookkeeping
    variables of TF1 train checkpoints (Adam moments, beta powers,
    global_step): everything the name maps do not cover."""
    tf_vars = {k.split(":")[0]: v for k, v in tf_vars.items()}
    return {k: v for k, v in tf_vars.items()
            if not (k.endswith(("/Adam", "/Adam_1"))
                    or k.split("/")[-1] in ("beta1_power", "beta2_power", "global_step"))}


def convert_fisrnet(tf_vars: Dict[str, np.ndarray]) -> dict:
    """TF FISRnet checkpoint variables -> FISRnet param tree."""
    return params.tree_from_tf_vars(tf_vars, fisrnet_name_map())


def convert_pwcnet(tf_vars: Dict[str, np.ndarray], pyr_lvls: int = 6,
                   flow_pred_lvl: int = 2, use_res_cx: bool = True) -> dict:
    """TF PWC-Net checkpoint variables -> PWC-Net param tree."""
    return params.tree_from_tf_vars(tf_vars, pwcnet_name_map(pyr_lvls, flow_pred_lvl,
                                                             use_res_cx))


def _get_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def export_fisrnet(tree: dict) -> Dict[str, np.ndarray]:
    """The inverse mapping (param tree -> TF variable dict)."""
    return {name: np.asarray(_get_path(tree, path)) for name, path in fisrnet_name_map().items()}


def export_pwcnet(tree: dict, **kw) -> Dict[str, np.ndarray]:
    return {name: np.asarray(_get_path(tree, path))
            for name, path in pwcnet_name_map(**kw).items()}


def check_tree(tree: dict, model: str, **convert_kw) -> dict:
    """`tree` if its key set and shapes are those of a fresh module of `model`
    ('fisrnet', or 'pwcnet' under convert_pwcnet's level options), else
    ValueError."""
    from fisr_tpu_torch.models.fisrnet import FISRnet
    from fisr_tpu_torch.models.pwcnet import PWCNet, PWCNetConfig

    if model == "fisrnet":
        ref = FISRnet(device="cpu")
    elif model == "pwcnet":
        ref = PWCNet(PWCNetConfig(**convert_kw), device="cpu")
    else:
        raise ValueError(f"unknown model {model!r}")
    want = params.jax_shapes(ref)
    got = {path: np.shape(leaf) for path, leaf in params.flatten_tree(tree)}
    if set(got) != set(want):
        raise ValueError(f"converted {model} tree structure mismatch: missing "
                         f"{sorted(set(want) - set(got))[:3]}, unexpected "
                         f"{sorted(set(got) - set(want))[:3]}")
    for path, shape in want.items():
        if tuple(got[path]) != shape:
            raise ValueError(f"converted {model} shape mismatch at {'/'.join(path)}: "
                             f"{shape} vs {tuple(got[path])}")
    return tree


def load_tf_checkpoint(prefix: str, model: str, verify_crc: bool = False,
                       **convert_kw) -> dict:
    """A TF1 TensorBundle prefix (the format of the released FISRnet-122000 /
    pwcnet.ckpt-595000) -> a validated param tree of numpy arrays in the JAX
    layout. `model` is 'fisrnet' or 'pwcnet'; `convert_kw` are
    convert_pwcnet's level options. Raises KeyError listing missing
    variables, ValueError where the key set or a shape differs from a fresh
    module's (`check_tree`)."""
    from fisr_tpu_torch.convert.tensor_bundle import read_bundle

    if model not in ("fisrnet", "pwcnet"):
        raise ValueError(f"unknown model {model!r}")
    tf_vars = normalize_tf_vars(read_bundle(prefix, verify=verify_crc))
    tree = (convert_fisrnet(tf_vars) if model == "fisrnet"
            else convert_pwcnet(tf_vars, **convert_kw))
    return check_tree(tree, model, **convert_kw)
