"""Row gathers by edge endpoint (torch counterpart of
``graphcast_lite_tpu.ops.gather``, forward only).

``gather_rows(table, idx)`` is ``table[idx]`` along rows.  The JAX package
gives the gather a custom VJP whose adjoint runs through the sorted segment
kernel (the sort aux ``senders_aux`` / ``receivers_aux``); that adjoint
comes with training (ROADMAP A6).
"""

from __future__ import annotations

import torch

__all__ = ["gather_rows"]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, F] rows picked by ``idx`` [E] -> [E, F]."""
    return table.index_select(0, idx)
