"""The persistent walk of the tiled cores (csrc/mlp_head.cuh, csrc/ngp_head.cuh),
shared by the wrappers of K2-K7.

A core kernel's grid is min(tile rows, MAX_BLOCKS) blocks. The ntiles * nz
tile rows (32 x 8 tiles, tile-major, z fastest) are dealt in contiguous
ranges, one a block, in block order. The block count is a constant, not
the card's SM count, so every sum over blocks has one order on any card.
"""

from __future__ import annotations

from phys_autodiff_tpu_torch.kernels.residuals import num_tiles
from phys_autodiff_tpu_torch.utils.config import GridSpec

#: Most blocks of the persistent grid (csrc/mlp_head.cuh and
#: csrc/ngp_head.cuh NBLK): two on each of the H100's 132 SMs.
MAX_BLOCKS = 264


def num_blocks(g: GridSpec) -> int:
    """Blocks of the persistent grid: one per tile row up to MAX_BLOCKS."""
    return min(num_tiles(g) * g.nz, MAX_BLOCKS)


def block_ranges(g: GridSpec) -> list[tuple[int, int]]:
    """The contiguous range [r0, r1) of tile rows of each block, in block
    order (csrc/mlp_head.cuh block_rows)."""
    nrows, nblk = num_tiles(g) * g.nz, num_blocks(g)
    return [(b * nrows // nblk, (b + 1) * nrows // nblk) for b in range(nblk)]


def block_of_row(r: int, nrows: int, nblk: int) -> int:
    """The block whose range holds tile row r (csrc/mlp_head.cuh
    block_of_row): how K4's and K6's dAB sums find the blocks that walked a
    tile."""
    return ((r + 1) * nblk - 1) // nrows

