"""Halo tiling (port of fisr_tpu/infer/halo.py).

`halo_map(f, x, grid, halo, ref_hw)` runs a conv segment `f` over a batch of
patches, each grown by `halo` px of real neighbour values. Where f's
receptive radius is at most `halo`, patch interiors equal f on the whole
frame; only a band of at most `halo` px at the frame border differs (zero
ring instead of f's own SAME padding). PWC-Net tiles its large-extent stages
through it, and the port reproduces the tiling so that it matches the JAX
package at every size, border band included.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["halo_map", "halo_exchange", "patchify", "unpatchify"]


def patchify(x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [gh*gw*B, H/gh, W/gw, C], patch-major, batch minor."""
    gh, gw = grid
    b, h, w, c = x.shape
    t = x.reshape(b, gh, h // gh, gw, w // gw, c)
    return t.permute(1, 3, 0, 2, 4, 5).reshape(gh * gw * b, h // gh, w // gw, c)


def unpatchify(y: torch.Tensor, grid: Tuple[int, int], b: int) -> torch.Tensor:
    """Inverse of patchify: [gh*gw*B, sh, sw, C] -> [B, gh*sh, gw*sw, C]."""
    gh, gw = grid
    _, sh, sw, c = y.shape
    t = y.reshape(gh, gw, b, sh, sw, c)
    return t.permute(2, 0, 3, 1, 4, 5).reshape(b, gh * sh, gw * sw, c)


def halo_exchange(cores: torch.Tensor, grid: Tuple[int, int], b: int,
                  halo: int) -> torch.Tensor:
    """Grow each patch core by `halo` px of its neighbours' values; the frame
    border is zero-filled. [gh*gw*B, sh, sw, C] -> [.., sh+2h, sw+2h, C]."""
    gh, gw = grid
    n, sh, sw, c = cores.shape
    if halo == 0:
        return cores
    t = cores.reshape(gh, gw, b, sh, sw, c)
    zrow = cores.new_zeros((1, gw, b, halo, sw, c))
    top = torch.cat([zrow, t[:-1, :, :, sh - halo:]], dim=0)
    bot = torch.cat([t[1:, :, :, :halo], zrow], dim=0)
    t2 = torch.cat([top, t, bot], dim=3)
    zcol = cores.new_zeros((gh, 1, b, sh + 2 * halo, halo, c))
    left = torch.cat([zcol, t2[:, :-1, :, :, sw - halo:]], dim=1)
    right = torch.cat([t2[:, 1:, :, :, :halo], zcol], dim=1)
    t3 = torch.cat([left, t2, right], dim=4)
    return t3.reshape(n, sh + 2 * halo, sw + 2 * halo, c)


def _scaled(v: int, num: int, den: int, what: str) -> int:
    out = v * num
    if out % den:
        raise ValueError(f"{what}: {v} * {num}/{den} is not integral")
    return out // den


def halo_map(f: Callable, x: torch.Tensor, grid: Tuple[int, int], halo: int,
             ref_hw: Tuple[int, int]):
    """Run stage `f` patch-batched over full-frame tensors with real halos.

    x:      a [B, H, W, C] tensor at `ref_hw` scaled by a rational factor;
            f maps its patch batch to a tensor or a tuple of patch outputs.
    grid:   (gh, gw), dividing ref_hw with integral scaled patches and halos.
    halo:   overlap width in ref-scale pixels.
    Returns f's outputs reassembled to full frames, in f's structure.
    """
    gh, gw = grid
    rh, rw = ref_hw
    if rh % gh or rw % gw:
        raise ValueError(f"grid {grid} does not divide ref {ref_hw}")
    sh, sw = rh // gh, rw // gw
    b, h, w, _ = x.shape
    hh = _scaled(halo, h, rh, "halo h")
    if hh != _scaled(halo, w, rw, "halo w"):
        raise ValueError("anisotropic scaled halo unsupported")
    out = f(halo_exchange(patchify(x, grid), grid, b, hh))

    def stitch(y):
        _, ph, pw, c = y.shape
        psh = _scaled(sh, ph, sh + 2 * halo, "out patch h")
        hh = _scaled(halo, ph, sh + 2 * halo, "out halo h")
        psw = _scaled(sw, pw, sw + 2 * halo, "out patch w")
        hw = _scaled(halo, pw, sw + 2 * halo, "out halo w")
        return unpatchify(y[:, hh:hh + psh, hw:hw + psw, :], grid, b)

    return stitch(out) if isinstance(out, torch.Tensor) else tuple(stitch(y) for y in out)
