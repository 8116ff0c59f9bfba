"""Row gathers by edge endpoint, with the segment-sum kernel as adjoint
(torch counterpart of ``graphcast_lite_tpu.ops.gather``).

``gather_rows(table, idx, aux)`` is ``table[idx]`` along rows.  Plain
autograd would differentiate it to an unsorted scatter-add (``index_add_``,
whose CUDA atomics make the sums change from run to run).  Given ``aux``,
the sorted CSR of ``idx`` over the table's rows, the adjoint is instead

    d table = segment_sum(g[perm], indptr)

where ``perm`` sorts the edges by their index (``None`` where ``idx`` is
already sorted, as a graph's receivers are), through the segment-sum
kernel (``ops.cuda_segment``): the JAX package's ``_gather_bwd``.  The JAX
package makes that adjoint opt-in (``GCLT_FAST_GATHER_ADJ=1``) and by
default differentiates to XLA's scatter; the port sends every segment sum
through its kernel, so it takes the kernel adjoint by default.  Both are
the same gradient up to the order of the additions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda_segment

__all__ = ["gather_rows"]

# (perm [E] or None, indptr [table rows + 1]): the sorted CSR of an index.
GatherAux = Tuple[Optional[torch.Tensor], torch.Tensor]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, perm, indptr):
        ctx.save_for_backward(perm, indptr)
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        perm, indptr = ctx.saved_tensors
        g_sorted = g.contiguous() if perm is None else g.index_select(0, perm)
        d_table = cuda_segment.segment_sum(g_sorted, indptr,
                                           indptr.numel() - 1)
        return d_table, None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                aux: GatherAux) -> torch.Tensor:
    """[N, F] rows picked by ``idx`` [E] -> [E, F].

    ``aux`` = (perm, indptr), the sorted CSR of ``idx`` over the N rows
    (``graphs.structure.sender_csr``; perm ``None`` for a sorted index),
    makes the adjoint the segment-sum kernel; where no gradient is taken
    the gather is a plain ``index_select``."""
    perm, indptr = aux
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table.index_select(0, idx)
    if indptr.numel() - 1 != table.shape[0]:
        raise ValueError(f"gather_rows: CSR over {indptr.numel() - 1} rows, "
                         f"table of {table.shape[0]}")
    return _GatherRows.apply(table, idx, perm, indptr)
