"""Row blocks for the dense O(N^2) passes.  Counterpart of the block
helpers of `summersph_tpu/utils/jax_utils.py`: a dense pass sums a block
of rows against every column at a time, so that its [B, N_cols]
temporaries stay bounded.
"""

from __future__ import annotations

import torch


def row_blocks(n: int, block: int, device=None) -> torch.Tensor:
    """[nb, block] int64 row-index blocks covering range(n); the last
    block repeats index n - 1 up to its length (wasted rows, which
    `unblock` drops)."""
    nb = -(-n // block)
    idx = torch.clamp(torch.arange(nb * block, device=device), max=n - 1)
    return idx.reshape(nb, block)


def unblock(x: torch.Tensor, n: int) -> torch.Tensor:
    """Undo the stacking of row blocks: [nb, block, ...] -> [n, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))[:n]


def pick_block(n: int, cols: int, budget: int = 1 << 22, lo: int = 8,
               hi: int = 1024) -> int:
    """Rows per block so that block x cols pair elements stay near
    `budget`: a power of two in [lo, hi], at most n."""
    b = max(lo, min(hi, budget // max(cols, 1)))
    p = 1
    while p * 2 <= b:
        p *= 2
    return min(p, max(1, n))


__all__ = ["row_blocks", "unblock", "pick_block"]
