"""The batched scan over more cells than the card holds at once.

The lane sweep (``ops.consolidate``), the crossed grid and the Monte-Carlo
studies (``parallel.mesh``) all run ``ops.solve.solve_core_batched`` over
more cells (lanes, replicas, replica x lane pairs) than the card may hold
at once, so they split the cells into chunks, through one loop
(``solve_cells``).  Cells are independent: no output depends on the chunk
size.
"""

from __future__ import annotations

import torch

from karpenter_core_tpu_torch.kernels import batch
from karpenter_core_tpu_torch.ops import solve as solve_ops

# The batched scan's peak device memory per (slot, instance type) of one
# cell: phase 8 of chip_smoke.py measured 2.08 GB at B = 8 against 0.24 GB
# solo (N = 8,192, I = 1,000), 32 bytes a (slot, type) for each tenant more.
SCAN_BYTES_PER_SLOT_TYPE = 32
# The stacked inputs of one cell, and the working planes the scan derives
# from them, counted as this many times the inputs' bytes.
INPUT_COPIES = 4
MEMORY_SHARE = 0.5  # of the card's free memory one chunk may take
CPU_CHUNK = 16  # cells a chunk on the CPU (the twins run them one by one)


def nbytes(tree) -> int:
    """The bytes of every tensor leaf of ``tree``."""
    total = []
    batch.tree_map(lambda t: total.append(t.numel() * t.element_size()), tree)
    return sum(total)


def chunk_size(n_cells: int, cell_bytes: int, device) -> int:
    """Cells a batched scan takes at once: as many as fit in
    ``MEMORY_SHARE`` of the card's free memory (the caching allocator's idle
    blocks counted free) at ``cell_bytes`` each, spread evenly over the
    chunks that takes; ``CPU_CHUNK`` on the CPU."""
    dev = torch.device(device)
    if n_cells <= 0:
        return 1
    if dev.type != "cuda":
        fit = CPU_CHUNK
    else:
        free, _ = torch.cuda.mem_get_info(dev)
        free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        fit = int(free * MEMORY_SHARE) // max(int(cell_bytes), 1)
    fit = max(1, min(fit, n_cells))
    n_chunks = -(-n_cells // fit)
    return -(-n_cells // n_chunks)


def cell_bytes(n_slots: int, shared) -> int:
    """The device memory one cell of a chunk takes, by estimate: the scan's
    planes over (slot, type) and the cell's stacked inputs (``shared``: the
    tuple of planes every cell repeats, the statics second)."""
    n_it = shared[1].it_alloc.shape[0]
    return SCAN_BYTES_PER_SLOT_TYPE * n_slots * n_it + INPUT_COPIES * nbytes(shared)


def solve_cells(shared, key_has_bounds, n_cells: int, n_slots: int, keep, *, count=None,
                open_=None, it_avail=None, n_passes: int = 1, features=None,
                use_kernels: bool = True) -> tuple:
    """``keep(outputs)`` of the batched scan over ``n_cells`` cells, a chunk
    of cells at a time, concatenated over the cells.  Every cell solves the
    planes of ``shared`` (ClassTensors, StaticArrays, ExistingState or None,
    ExistingStatic or None) over ``n_slots`` new-node slots, with its own
    class counts ``count`` (i32[X, C]), open mask ``open_`` (bool[X, E])
    and offering availability ``it_avail(lo, hi)`` (cells lo:hi's,
    bool[hi - lo, I, Z, CT]) where they are given."""
    chunk = chunk_size(n_cells, cell_bytes(n_slots, shared), shared[0].count.device)
    parts = []
    for lo in range(0, n_cells, chunk):
        hi = min(lo + chunk, n_cells)
        cls_b, sa_b, ex_b, exs_b = batch.repeat(shared, hi - lo)
        if count is not None:
            cls_b = cls_b._replace(count=count[lo:hi])
        if open_ is not None:
            ex_b = ex_b._replace(open_=open_[lo:hi])
        if it_avail is not None:
            sa_b = sa_b._replace(it_avail=it_avail(lo, hi).contiguous())
        out = solve_ops.solve_core_batched(cls_b, sa_b, n_slots, key_has_bounds, ex_b, exs_b,
                                           n_passes=n_passes, features=features,
                                           use_kernels=use_kernels)
        parts.append(keep(out))
        del out, cls_b, sa_b, ex_b, exs_b
    return tuple(p[0] if len(p) == 1 else torch.cat(p) for p in zip(*parts))
