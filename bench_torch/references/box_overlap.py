"""The plain reference of the sphere broad phase, in plain PyTorch.

The semantics are the kwohlfahrt/collision reference's: the boxes are
center - radius and center + radius, computed in the scene's float type,
and a pair of ids collides when its boxes strictly overlap on all three
axes; each unordered pair counts once and no sphere pairs with itself.

The spheres are sorted by the lower x edge of their boxes. A block of
sorted rows is tested against every sorted column from the block's first
row up to the last column whose lower x edge is below the block's
highest upper x edge, as a dense boolean matrix, keeping column > row.
A pair whose sorted positions are p < q is tested once, in the block
that holds row p. Blocks shrink until a matrix holds at most ``BUDGET``
elements. It imports nothing of the program under test.
"""

import torch

#: Most elements of one block's test matrix.
BUDGET = 1 << 26

#: The precision below each float type, for the control.
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}


def _blocks(coords, radii, dtype):
    """Yield (ids, s, mask) a block: ``mask[i, j]`` says whether the
    sphere at sorted position s + i collides with the one at s + j;
    ``ids`` maps sorted positions to ids."""
    c = coords.to(dtype)
    r = radii.to(dtype)[:, None]
    lo, hi = c - r, c + r
    ids = torch.argsort(lo[:, 0], stable=True)
    lo, hi = lo[ids], hi[ids]
    # Searches run on exact widenings of the edges (bfloat16 has none).
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    xlo = lo[:, 0].to(wide).contiguous()
    n = lo.shape[0]
    rows, s = 256, 0
    while s < n:
        e_rows = min(s + rows, n)
        reach = hi[s:e_rows, 0].max().to(wide).reshape(1)
        e = max(int(torch.searchsorted(xlo, reach)), e_rows)
        if rows * (e - s) > BUDGET and rows > 8:
            rows //= 2
            continue
        a_lo, a_hi = lo[s:e_rows, None, :], hi[s:e_rows, None, :]
        b_lo, b_hi = lo[None, s:e, :], hi[None, s:e, :]
        mask = (a_hi[..., 0] > b_lo[..., 0]) & (a_lo[..., 0] < b_hi[..., 0])
        for ax in (1, 2):
            mask &= (a_hi[..., ax] > b_lo[..., ax])
            mask &= (a_lo[..., ax] < b_hi[..., ax])
        k = e_rows - s
        pos = torch.arange(k, device=mask.device)
        mask[:, :k] &= pos[None, :] > pos[:, None]
        yield ids, s, mask
        s = e_rows
        if 4 * rows * (e - s + rows) < BUDGET:
            rows *= 2


def count(coords, radii, dtype):
    """The number of colliding pairs."""
    total = torch.zeros((), dtype=torch.int64, device=coords.device)
    for _, _, mask in _blocks(coords, radii, dtype):
        total += mask.sum()
    return int(total)


def pairs(coords, radii, dtype):
    """Yield (a, b) id tensors of the colliding pairs, a block at a
    time."""
    for ids, s, mask in _blocks(coords, radii, dtype):
        hit = mask.nonzero()
        yield ids[s + hit[:, 0]], ids[s + hit[:, 1]]
