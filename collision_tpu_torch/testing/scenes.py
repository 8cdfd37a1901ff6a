"""Scenes at the edges of the exact cull of the grid count, the column
masks and the big pass (``csrc/cull.cuh``), as numpy float32 arrays.

A row is tested against a cell or a stream row only if it meets that
set's union box; these scenes put rows exactly on the union's faces, keep
every row inside it, and leave cells, columns and rows empty. Each grid
scene comes with the (grid_dim, cell_capacity) it is meant for, each
column scene with its gxy.
"""

import numpy as np

_F32_INF = np.float32(np.inf)


def touching_lattice(k=9, radius=1 / 32):
    """k^3 spheres of one dyadic radius at centers i * 2r, binned at
    grid_dim 4 into cells two lattice planes wide: neighbouring boxes meet
    exactly (a.hi == b.lo), inside cells and across cell faces, which the
    strict test counts as no pair. Every other sphere with an x-neighbour
    on each side is moved up by one ulp in x, so its box overlaps its +x
    neighbour's. Returns (coords, radii, grid_dim, cell_capacity)."""
    r = np.float32(radius)
    g = np.arange(k, dtype=np.float32) * (2 * r)
    coords = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1) \
        .reshape(-1, 3).copy()
    nudge = (np.arange(len(coords)) % 2 == 0) & (coords[:, 0] > 0) \
        & (coords[:, 0] < g[-1])
    coords[nudge, 0] = np.nextafter(coords[nudge, 0], _F32_INF)
    return coords, np.full(len(coords), r, np.float32), 4, 32


def half_cell_radii(n=500, seed=11):
    """n uniform spheres, all of radius 1/8, at grid_dim 4: cells 1/4
    wide, boxes as wide as a cell, so the union boxes of neighbouring
    cells overlap and the cull keeps (almost) every row. Returns (coords,
    radii, grid_dim, cell_capacity)."""
    rng = np.random.RandomState(seed)
    coords = rng.random((n, 3)).astype(np.float32)
    return coords, np.full(n, 0.125, np.float32), 4, 32


def full_cell_beside_empty(seed=12):
    """300 spheres packed in cell (1, 1, 1) of a grid_dim 4 grid (three
    128-row chunks at cell_capacity 320) and 400 scattered ones that keep
    clear of its +z neighbour, which stays empty. Returns (coords, radii,
    grid_dim, cell_capacity)."""
    rng = np.random.RandomState(seed)
    cluster = 0.3 + 0.15 * rng.random((300, 3))
    scattered = rng.random((2000, 3))
    clear = ((scattered[:, 0] > 0.2) & (scattered[:, 0] < 0.55)
             & (scattered[:, 1] > 0.2) & (scattered[:, 1] < 0.55)
             & (scattered[:, 2] > 0.45) & (scattered[:, 2] < 0.8))
    scattered = scattered[~clear][:398]
    coords = np.concatenate([cluster, scattered, [[0, 0, 0], [0.999] * 3]]) \
        .astype(np.float32)
    radii = np.concatenate([rng.uniform(0, 0.02, 300),
                            rng.uniform(0, 0.05, 400)]).astype(np.float32)
    return coords, radii, 4, 320


GRID_SCENES = {"touching_lattice": touching_lattice,
               "half_cell_radii": half_cell_radii,
               "full_cell_beside_empty": full_cell_beside_empty}


def full_column_beside_empty(seed=14):
    """300 spheres packed in column (1, 1) of a gxy 4 grid and 400
    scattered ones that keep out of its +x neighbour, column (2, 1),
    which stays empty. Returns (coords, radii, gxy, col_capacity)."""
    rng = np.random.RandomState(seed)
    cluster = rng.random((300, 3))
    cluster[:, :2] = 0.27 + 0.2 * cluster[:, :2]
    scattered = rng.random((2000, 3))
    clear = ((scattered[:, 0] > 0.48) & (scattered[:, 0] < 0.77)
             & (scattered[:, 1] > 0.23) & (scattered[:, 1] < 0.52))
    scattered = scattered[~clear][:398]
    coords = np.concatenate([cluster, scattered, [[0, 0, 0], [0.999] * 3]]) \
        .astype(np.float32)
    radii = np.concatenate([rng.uniform(0, 0.02, 300),
                            rng.uniform(0, 0.05, 400)]).astype(np.float32)
    return coords, radii, 4, 384


def mid_word_chunks(seed=15):
    """Four columns (gxy 2) of 81, 109, 50 and 30 spheres, radii U(0,
    0.1): chunks of 17, 45, 50 and 30 live a-rows, whose last mask word
    ends mid-word, in the first and in the second half. Returns (coords,
    radii, gxy, col_capacity)."""
    rng = np.random.RandomState(seed)
    parts = []
    for (cx, cy), k in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                           (80, 109, 50, 29)):
        c = rng.random((k, 3))
        c[:, 0] = 0.02 + 0.45 * c[:, 0] + 0.5 * cx
        c[:, 1] = 0.02 + 0.45 * c[:, 1] + 0.5 * cy
        parts.append(c)
    coords = np.concatenate(parts + [[[0, 0, 0], [1, 1, 1]]]) \
        .astype(np.float32)
    radii = rng.uniform(0, 0.1, len(coords)).astype(np.float32)
    return coords, radii, 2, 128


def _column_scene(grid_scene):
    def scene():
        coords, radii, gxy, _ = grid_scene()
        return coords, radii, gxy, None
    scene.__doc__ = grid_scene.__doc__
    return scene


#: The column masks' cull (a lane against a 32-row mask word's union
#: box) at its edges: each scene returns (coords, radii, gxy,
#: col_capacity or None for ``columns.default_column_config``'s).
COLUMN_SCENES = {"touching_lattice": _column_scene(touching_lattice),
                 "half_cell_radii": _column_scene(half_cell_radii),
                 "full_column_beside_empty": full_column_beside_empty,
                 "mid_word_chunks": mid_word_chunks}


def _ids(ids):
    return np.asarray(ids, np.int32).view(np.float32)


def touching_big_pass():
    """(rows f32[3, 64, 8], zlo f32[3], zhi f32[3], stream f32[4, 8,
    128]): a big table (``hetero._bigs_table``'s layout: xlo ylo zlo xhi
    yhi zhi id-bits +inf; dead bigs all +inf but the id) and a stream
    (channels xlo ylo zlo xhi yhi zhi id-bits, 0) whose bigs meet the rows'
    union boxes exactly.

    Row 0 is a dyadic 8x4x4 lattice of boxes. For each axis and side of
    its union box, one giant (chunk 0, tested against every row) touches
    the face (no pair) and one reaches one ulp across it (pairs with the
    lanes on the face). Row 1 holds only pad lanes (all +inf), row 2
    parked lanes ([+inf, -inf]) and 28 live ones, row 3 row 0 moved up by
    1/4 in z with every other lane a pad lane; chunks 1-2, z-sorted, touch
    and cross row 3's union faces the same way, among random boxes.
    """
    rng = np.random.RandomState(13)
    r = np.float32(1 / 64)
    lane = np.arange(128)
    c = np.stack([lane % 8, lane // 8 % 4, lane // 32]).astype(np.float32)
    c = np.float32(0.5) + c * (2 * r)                            # [3, 128]
    stream = np.full((4, 8, 128), _F32_INF, np.float32)
    stream[:, 7] = 0

    def put(row, centers, live):
        stream[row, 0:3] = np.where(live, centers - r, _F32_INF)
        stream[row, 3:6] = np.where(live, centers + r, _F32_INF)
        stream[row, 6] = _ids(row * 128 + lane)

    put(0, c, np.ones(128, bool))
    put(2, c + np.float32(0.125), lane < 28)
    stream[2, 0:3, 28:] = _F32_INF                      # parked: [+inf, -inf]
    stream[2, 3:6, 28:] = -_F32_INF
    c3 = c + np.array([[0], [0], [0.25]], np.float32)
    put(3, c3, lane % 2 == 0)

    def face_bigs(row):
        """Twelve boxes against stream row ``row``'s union: per axis and
        side, one touching its face and one a ulp across it."""
        box = stream[row][:, stream[row, 0] < _F32_INF]
        ulo, uhi = box[0:3].min(1), box[3:6].max(1)
        out = []
        for axis in range(3):
            for side in ("hi", "lo"):
                for across in (False, True):
                    lo = ulo - np.float32(0.25)
                    hi = uhi + np.float32(0.25)
                    if side == "hi":
                        lo[axis] = np.nextafter(uhi[axis], -_F32_INF) \
                            if across else uhi[axis]
                    else:
                        hi[axis] = np.nextafter(ulo[axis], _F32_INF) \
                            if across else ulo[axis]
                    out.append(np.concatenate([lo, hi]))
        return np.array(out, np.float32)

    def random_bigs(k, z0):
        ctr = rng.random((k, 3)).astype(np.float32) * np.float32(0.5) \
            + np.float32(0.4)
        ctr[:, 2] = z0 + ctr[:, 2] * np.float32(0.3)
        rad = rng.uniform(0.01, 0.08, (k, 1)).astype(np.float32)
        return np.concatenate([ctr - rad, ctr + rad], 1)

    boxes0 = np.concatenate([face_bigs(0), random_bigs(20, 0.3)])
    boxes12 = np.concatenate([face_bigs(3), random_bigs(116, 0.5)])
    boxes12 = boxes12[np.argsort((boxes12[:, 2] + boxes12[:, 5]) / 2,
                                 kind="stable")]
    rows = np.full((192, 8), _F32_INF, np.float32)
    rows[:32, :6] = boxes0
    rows[64:, :6] = boxes12
    rows[:, 6] = _ids(np.arange(192))
    rows = rows.reshape(3, 64, 8)
    live = rows[..., 0] < _F32_INF
    zlo = np.where(live, rows[..., 2], _F32_INF).min(1)
    zhi = np.where(live, rows[..., 5], -_F32_INF).max(1)
    return rows, zlo.astype(np.float32), zhi.astype(np.float32), stream


def _slab_scene(grid_scene, gx=None):
    def scene():
        coords, radii, grid_dim, _ = grid_scene()
        return coords, radii, gx or grid_dim, None
    scene.__doc__ = grid_scene.__doc__ + (
        f" As a slab scene: gx {gx}." if gx else "")
    return scene


def slab_beside_empty(seed=17):
    """300 spheres packed in slab 1 of a gx 4 plan (z in [0.3, 0.45]:
    windows of up to ~300 lanes, past two 128-lane rows), 200 scattered in
    slab 0 and 150 in slab 3; slab 2 stays empty, so slab 1's windows
    into it are empty. Returns (coords, radii, gx, col_capacity)."""
    rng = np.random.RandomState(seed)

    def part(k, x0, x1, z0, z1):
        c = rng.random((k, 3))
        c[:, 0] = x0 + (x1 - x0) * c[:, 0]
        c[:, 2] = z0 + (z1 - z0) * c[:, 2]
        return c

    coords = np.concatenate([part(200, 0.01, 0.24, 0, 1),
                             part(300, 0.26, 0.49, 0.3, 0.45),
                             part(150, 0.76, 0.99, 0, 1),
                             [[0, 0, 0], [1, 1, 1]]]).astype(np.float32)
    radii = np.concatenate([rng.uniform(0, 0.05, 200),
                            rng.uniform(0, 0.02, 300),
                            rng.uniform(0, 0.05, 152)]).astype(np.float32)
    return coords, radii, 4, 320


def mid_word_slabs(seed=18):
    """Four slabs (gx 4) of 81, 109, 50 and 30 spheres, radii U(0, 0.1):
    chunks of 17, 45, 50 and 30 live a-rows, whose last mask word ends
    mid-word, in the first and in the second half. Returns (coords,
    radii, gx, col_capacity)."""
    rng = np.random.RandomState(seed)
    parts = []
    for x, k in enumerate((80, 109, 50, 29)):
        c = rng.random((k, 3))
        c[:, 0] = 0.02 + 0.21 * c[:, 0] + 0.25 * x
        parts.append(c)
    coords = np.concatenate(parts + [[[0, 0, 0], [1, 1, 1]]]) \
        .astype(np.float32)
    radii = rng.uniform(0, 0.1, len(coords)).astype(np.float32)
    return coords, radii, 4, 128


def odd_windows(seed=19):
    """Three slabs (gx 3) of 127, 250 and 190 spheres, radii U(0, 0.05):
    slab 1 starts at sorted position 127, so its chunks (and every window
    opening at a slab start) start at odd positions, the first at a
    stream row's last lane, and a warp's lane pair there spans two stream
    rows. Returns (coords, radii, gx, col_capacity)."""
    rng = np.random.RandomState(seed)
    parts = []
    for (x0, x1), k in zip(((0.01, 0.32), (0.34, 0.65), (0.67, 0.99)),
                           (126, 250, 189)):
        c = rng.random((k, 3))
        c[:, 0] = x0 + (x1 - x0) * c[:, 0]
        parts.append(c)
    coords = np.concatenate(parts + [[[0, 0, 0], [1, 1, 1]]]) \
        .astype(np.float32)
    radii = rng.uniform(0, 0.05, len(coords)).astype(np.float32)
    return coords, radii, 3, 256


#: The slab kernels' cull at its edges: each scene returns (coords,
#: radii, gx, col_capacity or None for ``slabs.default_slab_config``'s);
#: ``SLAB_EDGES`` names the edges (:func:`slab_edges`) each must reach.
SLAB_SCENES = {"touching_lattice": _slab_scene(touching_lattice),
               "half_cell_radii": _slab_scene(half_cell_radii, gx=2),
               "slab_beside_empty": slab_beside_empty,
               "mid_word_slabs": mid_word_slabs,
               "odd_windows": odd_windows}
SLAB_EDGES = {"touching_lattice": {"touching_faces", "ulp_across_faces"},
              "half_cell_radii": {"long_windows"},
              "slab_beside_empty": {"empty_beside", "long_windows"},
              "mid_word_slabs": {"mid_word_low", "mid_word_high"},
              "odd_windows": {"odd_starts", "start_127"}}


def slab_edges(stream, starts, w0, wcap, gx):
    """The edges of the slab kernels that a slab plan's numpy fields
    reach: "odd_starts" and "start_127" (a live window from an odd
    position, from the last lane of a stream row), "long_windows" (one
    past 128 lanes), "empty_beside" (a live slab beside an empty one),
    "mid_word_low" / "mid_word_high" (a chunk whose last live a-row ends
    inside its first or second mask word), "touching_faces" and
    "ulp_across_faces" (a box of slab x whose x-hi equals the x-lo of a
    box in slab x+1, or lies one ulp above it)."""
    edges = set()
    live = wcap.reshape(-1) > 0
    w = w0.reshape(-1)[live]
    if (w % 2 == 1).any():
        edges.add("odd_starts")
    if (w % 128 == 127).any():
        edges.add("start_127")
    if (wcap > 128).any():
        edges.add("long_windows")
    occ = np.diff(starts[:gx + 1].astype(np.int64))
    if ((occ[:-1] > 0) & (occ[1:] == 0)).any():
        edges.add("empty_beside")
    ends = set((occ[occ > 0] % 64).tolist())
    if ends & set(range(1, 32)):
        edges.add("mid_word_low")
    if ends & set(range(33, 64)):
        edges.add("mid_word_high")
    xlo = stream[:, 0, :].reshape(-1)
    xhi = stream[:, 3, :].reshape(-1)
    for x in range(gx - 1):
        hi = xhi[starts[x]:starts[x + 1]]
        lo = xlo[starts[x + 1]:starts[x + 2]]
        if np.isin(hi, lo).any():
            edges.add("touching_faces")
        if np.isin(hi, np.nextafter(lo, _F32_INF)).any():
            edges.add("ulp_across_faces")
    return edges
