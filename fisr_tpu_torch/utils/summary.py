"""Model summaries (port of fisr_tpu/utils/summary.py; the reference's
`show_all_variables`, utils.py:18-20, which used slim's model analyzer)."""

from __future__ import annotations

from torch import nn

__all__ = ["print_params", "param_table"]


def param_table(model: nn.Module, max_depth: int = 2):
    """[(path, (n_params, n_bytes))] aggregated to `max_depth` name levels."""
    rows = {}
    for name, t in model.named_parameters():
        key = "/".join(name.split(".")[:max_depth])
        n, nb = rows.get(key, (0, 0))
        rows[key] = (n + t.numel(), nb + t.numel() * t.element_size())
    return sorted(rows.items())


def print_params(model: nn.Module, max_depth: int = 2, name: str = "model") -> int:
    rows = param_table(model, max_depth)
    total = sum(n for _, (n, _) in rows)
    total_b = sum(b for _, (_, b) in rows)
    width = max((len(k) for k, _ in rows), default=10) + 2
    print(f"--- {name} variables ---")
    for key, (n, nb) in rows:
        print(f"  {key:<{width}} {n:>12,}  ({nb / 1e6:7.2f} MB)")
    print(f"  {'TOTAL':<{width}} {total:>12,}  ({total_b / 1e6:7.2f} MB)")
    return total
