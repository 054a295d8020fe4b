"""Grid-hash neighbor engine (v2): voxel bucketing + compacted candidate scan.

The brute-force engine (``neighbors.py``) scans all N points per query; its
``top_k`` over the full cloud dominates runtime and its memory is O(Q·N) —
unusable at ~1M points
(BASELINE.json config #3).  This engine replaces the full scan:

1. **Build** (once per cloud): points are bucketed into cells of edge
   ``cell_size`` (= search radius), sorted by linearized cell id via one
   device sort; a dense cell-start table maps cell id -> first sorted row.
   Optional per-point ``extras`` (e.g. normals) are carried along in grid
   order so queries can return gathered values with no second device memory gather.
2. **Query**: each query's 27 adjacent cells are 27 *contiguous runs* in the
   sorted arrays.  The runs are concatenated into one compact candidate list
   of static width ``window_cap`` (the max total occupancy of any 3x3x3 cell
   window, computed once at build) by pure index arithmetic — no sort, no
   scatter.  Exact distances mask the radius; ``top_k`` selects the k_max
   nearest.  Compaction matters: the naive fixed layout of 27 slots x
   ``cell_cap`` (the max *single-cell* occupancy) wastes ~80% of the gather
   rows on padding.

``window_cap`` bounds every possible query: any 3x3x3 window's in-grid
occupancy is bounded by the window centered at the per-axis-clamped cell, and
the build maximizes over all in-grid centers.  The result is EXACT —
identical to brute force up to top-k tie order.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from .neighbors import Neighborhoods

logger = logging.getLogger(__name__)

def _offsets_3d(halo: int) -> np.ndarray:
    r = range(-halo, halo + 1)
    return np.array([[dx, dy, dz] for dx in r for dy in r for dz in r],
                    dtype=np.int32)


_OFFSETS = _offsets_3d(1)  # (27, 3)

def _offsets_xy(halo: int) -> np.ndarray:
    """(2h+1)^2 xy offsets — the z-axis is linearized minor, so each (dx, dy)
    column of 2h+1 z-adjacent cells is ONE contiguous run in the sorted
    arrays."""
    r = range(-halo, halo + 1)
    return np.array([[dx, dy] for dx in r for dy in r], dtype=np.int32)


_OFFSETS_XY = _offsets_xy(1)


@jax.tree_util.register_pytree_node_class
class HashGrid:
    """Sorted-bucket grid; ``cell_cap``/``window_cap`` are static metadata
    (they set shapes).

    ``packed_sorted`` holds ``[points | extras]`` rows in cell order so one
    candidate gather serves both the distance test and the caller's values.
    ``cell_starts`` (built when the grid is dense enough) maps each linear cell
    id to its first row in the sorted arrays, replacing per-query binary
    searches with two table gathers."""

    def __init__(self, packed_sorted, orig_idx, cell_ids_sorted, origin, dims,
                 cell_size, cell_starts, cell_cap: int, has_table: bool,
                 window_cap: int, halo: int = 1,
                 cell_size_static: float | None = None,
                 group_cap: int = 0, group_cap16: int = 0,
                 xyrow_group_cap: int = 0, use_xyrow: bool = False,
                 xyrow_group_cap16: int = 0, xyrow_group_cap32: int = 0):
        self.packed_sorted = packed_sorted  # (N, 3+F) [points | extras], cell order
        self.orig_idx = orig_idx            # (N,) sorted position -> original index
        self.cell_ids_sorted = cell_ids_sorted  # (N,) int32 linear ids (ascending)
        self.origin = origin                # (3,)
        self.dims = dims                    # (3,) int32 cells per axis
        self.cell_size = cell_size          # ()
        self.cell_starts = cell_starts      # (n_cells+1,) int32 or (1,) dummy
        self.cell_cap = cell_cap            # static: max points per cell
        self.has_table = has_table          # static
        self.window_cap = window_cap        # static: max points per 3x3x3 window
        self.halo = halo                    # static: cells per side of window;
                                            # searches support radius <= halo*cell_size
        self.cell_size_static = cell_size_static  # host float copy of cell_size
                                            # (lets entry points check the
                                            # radius contract without a sync)
        self.group_cap = group_cap          # static: exact max number of
                                            # G=8-aligned groups any window's
                                            # runs need (0 = use the
                                            # conservative bound)
        self.group_cap16 = group_cap16      # same, for G=16 groups
        self.xyrow_group_cap = xyrow_group_cap  # static: exact group cap of
                                            # the 2h+1 xy-row runs (full-z
                                            # columns); 0 = not computed
        self.xyrow_group_cap16 = xyrow_group_cap16  # same, G=16 groups
        self.xyrow_group_cap32 = xyrow_group_cap32  # same, G=32 groups
        self.use_xyrow = use_xyrow          # static: the grouped gather uses
                                            # 2h+1 xy-row runs instead of
                                            # (2h+1)^2 z-column runs — chosen
                                            # at build when the full-z window
                                            # is barely wider (surface-like
                                            # clouds), trading ~1.5%% more
                                            # candidate lanes for 5x fewer
                                            # run lookups and less group
                                            # straddle

    @property
    def points_sorted(self):
        return self.packed_sorted[:, :3]

    def tree_flatten(self):
        children = (self.packed_sorted, self.orig_idx, self.cell_ids_sorted,
                    self.origin, self.dims, self.cell_size, self.cell_starts)
        return children, (self.cell_cap, self.has_table, self.window_cap,
                          self.halo, self.cell_size_static,
                          self.group_cap, self.group_cap16,
                          self.xyrow_group_cap, self.use_xyrow,
                          self.xyrow_group_cap16, self.xyrow_group_cap32)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


@jax.jit
def _build_device(points: jnp.ndarray, cell_size):
    pts = jnp.asarray(points, jnp.float32)
    n = pts.shape[0]
    origin = jnp.min(pts, axis=0)
    cell = jnp.floor((pts - origin) / cell_size).astype(jnp.int32)
    dims = jnp.max(cell, axis=0) + 1
    linear = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = jnp.arange(n, dtype=jnp.int32)
    ids_sorted, orig_idx = jax.lax.sort((linear, order), num_keys=1, is_stable=True)
    # max cell occupancy (for the host to pick cell_cap)
    seg_start = jnp.concatenate([jnp.ones((1,), bool), ids_sorted[1:] != ids_sorted[:-1]])
    seg = jnp.cumsum(seg_start.astype(jnp.int32)) - 1
    counts = jax.ops.segment_sum(jnp.ones((n,), jnp.int32), seg, num_segments=n)
    # dims + max_occ packed into ONE small array: the host build needs all
    # four scalars, and one device->host sync beats four
    meta = jnp.concatenate([dims, jnp.max(counts)[None]])
    return pts[orig_idx], orig_idx, ids_sorted, origin, dims, cell_size, meta


@functools.partial(jax.jit, static_argnames=("padded_len",))
def _cell_starts_device(ids_sorted: jnp.ndarray, padded_len: int) -> jnp.ndarray:
    """Cell-id → first-sorted-row lookup table, built on device in one
    program (ids past the largest cell id resolve to n automatically)."""
    return jnp.searchsorted(
        ids_sorted, jnp.arange(padded_len, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)


# Row-group size of the grouped feature-planar gather: one index fetches G
# consecutive sorted rows, so a gather bound by its index rate does 1/G the
# index work for a few % more straddle lanes, while a larger G widens the
# window the LRF/binning compute walks.  G=16 was chosen on the chip this
# system was first built for; re-sweeping 8/16/32 on the GPU is open
# (ROADMAP).
WINDOW_GROUP = 16

# Call-time override for the production window fetch's group size
# (0 = keep the default G=16).
_WINDOW_GROUP_OVERRIDE = int(__import__("os").environ.get(
    "SHOT_FPFH_WINDOW_GROUP", "0"))


def set_window_group(group: int) -> None:
    """Override the window fetch's row-group size (8/16/32; 0 = default 8).
    Clears jit caches — shapes (W = gc·G) change with the group."""
    global _WINDOW_GROUP_OVERRIDE
    assert group in (0, 8, 16, 32), group
    if group != _WINDOW_GROUP_OVERRIDE:
        _WINDOW_GROUP_OVERRIDE = group
        jax.clear_caches()


def window_group_default() -> int:
    return _WINDOW_GROUP_OVERRIDE or WINDOW_GROUP


def _group_cap(cell_starts: np.ndarray, dims_np: np.ndarray, halo: int,
               group: int = WINDOW_GROUP) -> int:
    """EXACT max number of G-aligned row groups any query window needs.

    Per (x, y, center-z) the z-column run is [cs[x,y,max(z-h,0)],
    cs[x,y,min(z+h,d2-1)+1]); its aligned-group need is
    ceil((start%G + len)/G).  A 2-D box-sum over the (2h+1)^2 xy offsets then
    maximizes over windows — the same structure as ``_window_caps``, so the
    build pays one more cheap host pass instead of shipping the conservative
    ceil(window/G)+2R bound (which cost ~20%% extra histogram width)."""
    d0, d1, d2 = (int(v) for v in dims_np)
    zc = np.arange(d2)
    zlo = np.maximum(zc - halo, 0)
    zhi = np.minimum(zc + halo, d2 - 1) + 1
    base = np.arange(d0 * d1, dtype=np.int64)[:, None] * d2
    start = cell_starts[base + zlo[None, :]].astype(np.int64)
    end = cell_starts[base + zhi[None, :]].astype(np.int64)
    ln = end - start
    g = np.where(ln > 0, (start % group + ln + group - 1) // group, 0)
    g = g.reshape(d0, d1, d2)
    w = 2 * halo + 1
    p = np.pad(g, ((halo, halo), (halo, halo), (0, 0)))
    acc = None
    for dx in range(w):
        for dy in range(w):
            piece = p[dx:dx + d0, dy:dy + d1, :]
            acc = piece.copy() if acc is None else acc + piece
    return int(acc.max())


def _xyrow_caps(cell_starts: np.ndarray, dims_np: np.ndarray, halo: int,
                group: int = WINDOW_GROUP) -> tuple[int, int]:
    """(max xy-row window occupancy, exact max G-aligned group count) for the
    xy-row run mode: per query, 2h+1 runs — one per dx offset — each spanning
    the (y-h .. y+h) columns at FULL z extent (those columns are consecutive
    in the z-minor linear id, so the span is one contiguous run).

    The window is a superset of the (2h+1)^2 z-column window (exactness is
    free); on surface-like clouds each column holds points only near the
    surface's z anyway, so the full-z widening is small while the run count
    drops 5x.  Host NumPy box-max, same rationale as ``_window_caps``."""
    d0, d1, d2 = (int(v) for v in dims_np)
    ys = np.arange(d1)
    ylo = np.maximum(ys - halo, 0)
    yhi = np.minimum(ys + halo, d1 - 1) + 1
    xbase = np.arange(d0, dtype=np.int64)[:, None] * (d1 * d2)
    start = cell_starts[xbase + ylo[None, :] * d2].astype(np.int64)   # (d0, d1)
    end = cell_starts[xbase + yhi[None, :] * d2].astype(np.int64)
    ln = end - start
    g = np.where(ln > 0, (start % group + ln + group - 1) // group, 0)
    w = 2 * halo + 1
    ln_p = np.pad(ln, ((halo, halo), (0, 0)))
    g_p = np.pad(g, ((halo, halo), (0, 0)))
    ln_acc = g_acc = None
    for dx in range(w):
        lp, gp = ln_p[dx:dx + d0], g_p[dx:dx + d0]
        ln_acc = lp.copy() if ln_acc is None else ln_acc + lp
        g_acc = gp.copy() if g_acc is None else g_acc + gp
    return int(ln_acc.max()), int(g_acc.max())


def _window_caps(cell_starts: np.ndarray, dims_np: np.ndarray, n: int,
                 halo: int = 1):
    """Max (2h+1)^3-window occupancy — HOST NumPy box-sums; it sizes the
    compacted candidate width.

    Host on purpose: the device formulation ran ~20 eager ops, each a
    separate dispatch plus a per-dims compile.  The same sums in vectorized
    NumPy on the already-transferred table take milliseconds."""
    counts = (cell_starts[1:] - cell_starts[:-1]).astype(np.int64)
    dense = counts.reshape(int(dims_np[0]), int(dims_np[1]), int(dims_np[2]))
    box = dense
    w = 2 * halo + 1
    for ax in (2, 1, 0):
        pad = [(halo, halo) if a == ax else (0, 0) for a in range(3)]
        p = np.pad(box, pad)
        acc = None
        for shift in range(w):
            sl = [slice(shift, shift + dense.shape[a]) if a == ax
                  else slice(None) for a in range(3)]
            piece = p[tuple(sl)]
            acc = piece.copy() if acc is None else acc + piece
        box = acc
    return min(int(box.max()), n)


# Content-keyed LRU of built grids.  The functional entry points
# (compute_shot_descriptor, compute_fpfh_descriptor, icp_*, normals) each
# rebuild their support grid per call; at 1M points a rebuild is host passes
# plus four ~12 MB host<->device transfers.  Hashing the input bytes instead
# costs ~10 ms/call, so repeated calls over the same cloud (scan+ref pairs,
# multiscale, bench warm reps, interactive use) skip the rebuild entirely.  Keyed on CONTENT (blake2b of the raw bytes), not object
# identity, so mutation or a fresh equal array both behave correctly.
_GRID_CACHE: dict = {}  # key -> (HashGrid, estimated device bytes)
_GRID_CACHE_MAX = int(__import__("os").environ.get("SHOT_FPFH_GRID_CACHE", "8"))
# Byte budget for retained device buffers (ADVICE r4: each cached 1M-point
# grid pins ~100 MB of device memory — packed_sorted + pow2-padded cell_starts — so a
# count-only LRU could silently park ~1 GB).  Default 1 GiB; env-tunable.
_GRID_CACHE_MAX_BYTES = int(float(
    __import__("os").environ.get("SHOT_FPFH_GRID_CACHE_BYTES", str(1 << 30))
))


def _grid_nbytes(grid) -> int:
    """Estimated device footprint: sum of the pytree leaves' nbytes."""
    return sum(
        int(leaf.nbytes)
        for leaf in jax.tree_util.tree_leaves(grid)
        if hasattr(leaf, "nbytes")
    )


def grid_cache_stats() -> dict:
    """Observability hook: entry count + total retained device bytes."""
    total = sum(nbytes for _, nbytes in _GRID_CACHE.values())
    return {"entries": len(_GRID_CACHE), "bytes": total}


def _grid_cache_key(pts: np.ndarray, cell_size: float, extras, halo: int):
    import hashlib

    h = hashlib.blake2b(pts.tobytes(), digest_size=16)
    if extras is not None:
        h.update(extras.tobytes())
        ext_shape = extras.shape
    else:
        ext_shape = None
    # the target device is part of the key: a process may build the same
    # cloud's grid for two backends (``jax.default_device``)
    return (pts.shape, ext_shape, float(cell_size), int(halo),
            str(jax.config.jax_default_device), h.digest())


def clear_grid_cache() -> None:
    _GRID_CACHE.clear()


def build_grid(points, cell_size: float, extras=None, halo: int = 1) -> HashGrid:
    """Content-cached grid build: host ``np.ndarray`` inputs hit a small LRU
    (size ``SHOT_FPFH_GRID_CACHE``, default 8; 0 disables) keyed on the raw
    bytes + cell size + halo, so repeated builds over the same cloud are
    ~10 ms of hashing instead of the full build.  Device-array inputs build
    uncached (downloading them to hash would cost the transfer the cache is
    meant to save)."""
    cacheable = (
        _GRID_CACHE_MAX > 0
        and isinstance(points, np.ndarray)
        and (extras is None or isinstance(extras, np.ndarray))
    )
    if not cacheable:
        return _build_grid_impl(points, cell_size, extras, halo)
    pts = np.ascontiguousarray(points, np.float32)
    ext = None if extras is None else np.ascontiguousarray(extras, np.float32)
    key = _grid_cache_key(pts, cell_size, ext, halo)
    hit = _GRID_CACHE.pop(key, None)
    if hit is not None:
        _GRID_CACHE[key] = hit  # re-insert: dict preserves order -> LRU
        return hit[0]
    grid = _build_grid_impl(pts, cell_size, ext, halo)
    nbytes = _grid_nbytes(grid)
    if nbytes <= _GRID_CACHE_MAX_BYTES:  # never cache an over-budget grid
        _GRID_CACHE[key] = (grid, nbytes)
    stats = grid_cache_stats()
    while _GRID_CACHE and (
        len(_GRID_CACHE) > _GRID_CACHE_MAX or stats["bytes"] > _GRID_CACHE_MAX_BYTES
    ):
        old_key = next(iter(_GRID_CACHE))
        if old_key == key and len(_GRID_CACHE) == 1:
            break  # keep at least the entry just inserted
        _, old_bytes = _GRID_CACHE.pop(old_key)
        stats = grid_cache_stats()
        logger.debug(
            "grid cache: evicted %.1f MB entry (now %d entries, %.1f MB retained)",
            old_bytes / 2**20, stats["entries"], stats["bytes"] / 2**20,
        )
    logger.debug(
        "grid cache: inserted %.1f MB grid (%d entries, %.1f MB retained, "
        "budget %d entries / %.0f MB)",
        nbytes / 2**20, stats["entries"], stats["bytes"] / 2**20,
        _GRID_CACHE_MAX, _GRID_CACHE_MAX_BYTES / 2**20,
    )
    return grid


def _build_grid_impl(points, cell_size: float, extras=None,
                     halo: int = 1) -> HashGrid:
    """Host wrapper: builds the grid, fixes ``cell_cap`` to the true max cell
    occupancy and ``window_cap`` to the true max 27-cell-window occupancy
    (each rounded up to a multiple of 8 to stabilize compile shapes).

    ``extras``: optional (N, F) per-point values (e.g. normals) carried along
    in grid order — queries with ``with_values=True`` then return
    ``[points | extras]`` rows for the selected neighbors at no extra gather.

    A dense cell-start lookup table is added when the cell count is moderate
    (≤ max(8N, 2^24)); pathologically sparse grids fall back to binary search
    over the 27 fixed cell slots."""
    out = _build_device(jnp.asarray(points, jnp.float32), jnp.float32(cell_size))
    pts_sorted, orig_idx, ids_sorted, origin, dims, size, meta = out
    meta_np = np.asarray(meta)        # ONE d2h sync: dims + max cell occupancy
    dims_np, max_occ = meta_np[:3], meta_np[3]
    cap = int(np.ceil(max(int(max_occ), 1) / 8) * 8)
    n = pts_sorted.shape[0]
    n_cells = int(dims_np[0]) * int(dims_np[1]) * int(dims_np[2])
    has_table = 0 < n_cells <= max(8 * n, 1 << 24)
    if has_table:
        # Window caps run on the HOST from one small download — the
        # device cap formulation was a chain of ~30 eager dispatches (diffs,
        # box sums), each with a per-dims compile.  The cell-start lookup
        # table is built ON DEVICE with one jitted searchsorted; when the
        # grid is denser than one cell per point the host copies the
        # (n_cells+1) table prefix (smaller than the sorted ids), otherwise
        # it downloads the ids and searchsorts locally.
        padded_len = 1 << int(np.ceil(np.log2(n_cells + 1)))
        cell_starts = _cell_starts_device(ids_sorted, padded_len)
        if n_cells + 1 <= n:
            cell_starts_np = np.asarray(cell_starts[:n_cells + 1])
        else:
            cell_starts_np = np.searchsorted(
                np.asarray(ids_sorted),
                np.arange(n_cells + 1, dtype=np.int64), side="left"
            ).astype(np.int32)
        # round the static width up to a multiple of 64 — fewer distinct
        # compile keys across clouds, negligible extra candidate padding
        wcap_raw = _window_caps(cell_starts_np, dims_np, n, halo)
        wcap = int(np.ceil(max(wcap_raw, 1) / 64) * 64)
        wcap = min(wcap, int(np.ceil(n / 8) * 8))
        # (the device table length was padded to the next power of two above
        # — searchsorted past the last id naturally yields n = empty — so
        # clouds with slightly different extents/radii reuse compiled query
        # programs)
        if n_cells <= 1 << 22:
            group_cap = int(np.ceil(max(
                _group_cap(cell_starts_np, dims_np, halo, 8), 1) / 16) * 16)
            group_cap16 = int(np.ceil(max(
                _group_cap(cell_starts_np, dims_np, halo, 16), 1) / 8) * 8)
            # xy-row mode: pick it when the full-z window's group cap is at
            # most a small margin above the z-column one — each extra group
            # costs a gather and 8 lanes of histogram, while the 5x-fewer
            # runs cut the index math; the +20% margin was set on the chip
            # this system was first built for (re-measuring on the GPU is
            # open, ROADMAP)
            _, xyrow_group_cap = _xyrow_caps(cell_starts_np, dims_np, halo, 8)
            xyrow_group_cap = int(np.ceil(max(xyrow_group_cap, 1) / 16) * 16)
            use_xyrow = xyrow_group_cap <= group_cap + max(16, group_cap // 5)
            # wider groups: G=16/32 cut the fetch's index count ~2/4x for a
            # few % more straddle lanes (see WINDOW_GROUP) — exact caps
            # so consumers can select G per call (set_window_group).  Only
            # computed when the xyrow mode is actually selected: volumetric
            # grids can never consume them, and the cold build path stays
            # free of dead host passes
            xyrow_group_cap16 = xyrow_group_cap32 = 0
            if use_xyrow:
                _, xyrow_group_cap16 = _xyrow_caps(cell_starts_np, dims_np, halo, 16)
                xyrow_group_cap16 = int(np.ceil(max(xyrow_group_cap16, 1) / 8) * 8)
                _, xyrow_group_cap32 = _xyrow_caps(cell_starts_np, dims_np, halo, 32)
                xyrow_group_cap32 = int(np.ceil(max(xyrow_group_cap32, 1) / 4) * 4)
        else:
            # very sparse grids (>4M cells): the exact pass would allocate
            # several n_cells-sized int64 temporaries — fall back to the
            # conservative bound (grouped consumers rarely see such grids)
            group_cap = 0
            group_cap16 = 0
            xyrow_group_cap = 0
            xyrow_group_cap16 = 0
            xyrow_group_cap32 = 0
            use_xyrow = False
    else:
        group_cap = 0
        group_cap16 = 0
        xyrow_group_cap = 0
        xyrow_group_cap16 = 0
        xyrow_group_cap32 = 0
        use_xyrow = False
        cell_starts = jnp.zeros((1,), jnp.int32)
        wcap = (2 * halo + 1) ** 3 * cap
    packed = pts_sorted
    if extras is not None:
        extras = jnp.asarray(extras, jnp.float32)
        packed = jnp.concatenate([pts_sorted, extras[orig_idx]], axis=1)
    return HashGrid(packed, orig_idx, ids_sorted, origin, dims,
                    jnp.asarray(cell_size, jnp.float32), cell_starts, cap,
                    has_table, wcap, halo,
                    cell_size_static=float(cell_size), group_cap=group_cap,
                    group_cap16=group_cap16, xyrow_group_cap=xyrow_group_cap,
                    use_xyrow=use_xyrow, xyrow_group_cap16=xyrow_group_cap16,
                    xyrow_group_cap32=xyrow_group_cap32)


def _cell_runs(grid: HashGrid, queries: jnp.ndarray):
    """(start, end) rows in the sorted arrays for each query's 27 cells."""
    qcell = jnp.floor((queries - grid.origin) / grid.cell_size).astype(jnp.int32)
    cells = qcell[:, None, :] + _offsets_3d(grid.halo)[None, :, :]  # (Qc, R, 3)
    in_grid = jnp.all((cells >= 0) & (cells < grid.dims), axis=-1)
    linear = (cells[..., 0] * grid.dims[1] + cells[..., 1]) * grid.dims[2] + cells[..., 2]

    if grid.has_table:
        safe = jnp.clip(linear, 0, grid.cell_starts.shape[0] - 2)
        start = jnp.where(in_grid, grid.cell_starts[safe], 0)
        end = jnp.where(in_grid, grid.cell_starts[safe + 1], 0)
    else:
        linear = jnp.where(in_grid, linear, -1)
        start = jnp.searchsorted(grid.cell_ids_sorted, linear, side="left")
        end = jnp.searchsorted(grid.cell_ids_sorted, linear, side="right")
        end = jnp.where(in_grid, end, start)
    return start.astype(jnp.int32), end.astype(jnp.int32)


def _zcolumn_runs(grid: HashGrid, queries: jnp.ndarray):
    """(start, end) rows for each query's (2h+1)^2 z-column runs.

    The linear cell id is z-minor, so the 2h+1 z-adjacent cells of each
    (dx, dy) offset form one contiguous segment: start = cell_starts at
    (x+dx, y+dy, max(z-h, 0)), end = cell_starts at (x+dx, y+dy,
    min(z+h, dz-1) + 1).  Table-less grids (pathologically sparse: n_cells >
    max(8N, 2^24), where the dense start table would dwarf the cloud) get the
    same runs from two binary searches over the sorted cell ids per column —
    slower, but every grouped-window consumer (SHOT/FPFH/PCA window paths,
    fused program, sharded descriptors, grid 1-NN) stays EXACT instead of
    silently returning empty windows (ADVICE r2 #1)."""
    h = grid.halo
    qcell = jnp.floor((queries - grid.origin) / grid.cell_size).astype(jnp.int32)
    xy = qcell[:, None, :2] + _offsets_xy(h)[None, :, :]  # (Qc, R, 2)
    in_grid = jnp.all((xy >= 0) & (xy < grid.dims[:2]), axis=-1)
    z_lo = jnp.maximum(qcell[:, 2:3], h) - h           # (Qc, 1)
    z_hi = jnp.minimum(qcell[:, 2:3] + h, grid.dims[2] - 1)
    in_grid = (in_grid & (qcell[:, 2:3] >= -h)
               & (qcell[:, 2:3] <= grid.dims[2] + h - 1) & (z_hi >= z_lo))
    base = (xy[..., 0] * grid.dims[1] + xy[..., 1]) * grid.dims[2]
    if grid.has_table:
        lo = jnp.clip(base + z_lo, 0, grid.cell_starts.shape[0] - 1)
        hi = jnp.clip(base + z_hi + 1, 0, grid.cell_starts.shape[0] - 1)
        start = jnp.where(in_grid, grid.cell_starts[lo], 0)
        end = jnp.where(in_grid, grid.cell_starts[hi], 0)
    else:
        lo_id = jnp.where(in_grid, base + z_lo, -1)
        hi_id = jnp.where(in_grid, base + z_hi, -1)
        start = jnp.searchsorted(grid.cell_ids_sorted, lo_id, side="left")
        end = jnp.searchsorted(grid.cell_ids_sorted, hi_id, side="right")
        end = jnp.where(in_grid, end, start)
    return start.astype(jnp.int32), jnp.maximum(end, start).astype(jnp.int32)


def _compacted_slots(grid: HashGrid, queries: jnp.ndarray):
    """(Qc, window_cap) candidate rows + validity: the (2h+1)^2 contiguous
    z-column runs of each query concatenated by pure index arithmetic
    (lane-friendly unrolled run tests — no sort, no scatter, no (Q, C, R)
    broadcast)."""
    start, end = _zcolumn_runs(grid, queries)         # (Qc, R)
    cnt = end - start
    cum = jnp.cumsum(cnt, axis=1)                     # inclusive
    excl = cum - cnt                                  # exclusive
    total = cum[:, -1]
    wc = grid.window_cap
    j = jnp.arange(wc, dtype=jnp.int32)[None, :]      # (1, wc)
    base = jnp.zeros((queries.shape[0], wc), jnp.int32)
    for c in range((2 * grid.halo + 1) ** 2):
        inrun = (j >= excl[:, c:c + 1]) & (j < cum[:, c:c + 1])
        base = base + inrun * (start[:, c:c + 1] - excl[:, c:c + 1])
    slots = base + j
    valid = j < total[:, None]
    n = grid.packed_sorted.shape[0]
    slots = jnp.where(valid, jnp.minimum(slots, n - 1), 0)
    return slots, valid


def _xyrow_runs(grid: HashGrid, queries: jnp.ndarray):
    """(start, end) rows for each query's 2h+1 xy-row runs: for each dx, the
    (y-h .. y+h) columns at FULL z extent are consecutive in the z-minor
    linear id, so they form ONE contiguous run.  Superset of the z-column
    window (exact for any radius ≤ halo·cell); see ``_xyrow_caps``."""
    h = grid.halo
    qcell = jnp.floor((queries - grid.origin) / grid.cell_size).astype(jnp.int32)
    dimy, dimz = grid.dims[1], grid.dims[2]
    x = qcell[:, 0:1] + jnp.arange(-h, h + 1, dtype=jnp.int32)[None, :]  # (Q, 2h+1)
    in_x = (x >= 0) & (x < grid.dims[0])
    y_lo = jnp.maximum(qcell[:, 1:2] - h, 0)
    y_hi = jnp.minimum(qcell[:, 1:2] + h, dimy - 1)
    ok = (in_x & (y_hi >= y_lo)
          & (qcell[:, 1:2] >= -h) & (qcell[:, 1:2] <= dimy + h - 1))
    lo = jnp.clip((x * dimy + y_lo) * dimz, 0, grid.cell_starts.shape[0] - 1)
    hi = jnp.clip((x * dimy + y_hi + 1) * dimz, 0, grid.cell_starts.shape[0] - 1)
    start = jnp.where(ok, grid.cell_starts[lo], 0)
    end = jnp.where(ok, grid.cell_starts[hi], 0)
    return start.astype(jnp.int32), jnp.maximum(end, start).astype(jnp.int32)


def grouped_window_gather(grid: HashGrid, queries: jnp.ndarray,
                          group: int = 0):
    """Gather each query's candidate window at ``group``-row granularity.

    A row gather bound by its index rate costs per index, not per byte, so
    fetching G consecutive rows per index from the table reshaped to
    ``(N/G, G·F)`` cuts the index work ~G× for the same bytes.  The
    z-column runs are contiguous, so each run needs ``len/G + 1`` aligned
    groups; lanes outside a run's true [start, end) are masked (they belong
    to cells outside the window — without the mask they could duplicate
    candidates of an adjacent run).

    Returns ``(values (Qc, F, W), rows (Qc, W), valid (Qc, W))`` — values are
    FEATURE-PLANAR (one (Qc, W) plane per packed feature, the layout
    ``models.shot.shot_from_window_ff`` consumes) with ``W = gc · G``, where
    ``gc`` is the exact build-time group cap for the active run mode
    (``xyrow_group_cap`` / ``group_cap`` / ``group_cap16``) or, when no exact
    cap was computed for this ``group``, the conservative
    ``ceil(window_cap/G) + 2R`` straddle bound; ``valid`` marks true window
    rows (radius test NOT applied here).  All intermediates are 2-D (Qc, ·)
    arrays.

    Surface-like grids (``use_xyrow``, chosen at build) source the runs from
    ``_xyrow_runs`` — 2h+1 full-z runs instead of (2h+1)^2 z-column runs —
    cutting the run-table lookups and group-straddle padding ~5x for ~1.5%
    more candidate lanes."""
    group = group or window_group_default()
    xyrow_caps = {
        8: getattr(grid, "xyrow_group_cap", 0),
        16: getattr(grid, "xyrow_group_cap16", 0),
        32: getattr(grid, "xyrow_group_cap32", 0),
    }
    use_xyrow = (bool(getattr(grid, "use_xyrow", False))
                 and xyrow_caps.get(group, 0) > 0)
    if use_xyrow:
        start, end = _xyrow_runs(grid, queries)          # (Qc, 2h+1)
    else:
        start, end = _zcolumn_runs(grid, queries)        # (Qc, R)
    n, f = grid.packed_sorted.shape
    n_groups_total = -(-n // group)
    # feature-planar group rows: [x0..x{G-1}, y0.., z0.., nx0.., ...]
    table = jnp.pad(
        grid.packed_sorted, ((0, n_groups_total * group - n), (0, 0)),
        constant_values=3.0e6,  # far sentinel: fails any radius test
    ).reshape(n_groups_total, group, f).transpose(0, 2, 1).reshape(
        n_groups_total, f * group
    )

    gs = start // group
    ge = -(-end // group)
    cnt = jnp.where(end > start, ge - gs, 0)
    cum = jnp.cumsum(cnt, axis=1)
    excl = cum - cnt
    total = cum[:, -1]

    r = (2 * grid.halo + 1) if use_xyrow else (2 * grid.halo + 1) ** 2
    # static group cap: each run j needs floor((end_j-1)/G) - floor(start_j/G)
    # + 1 <= ceil(len_j/G) + 1 aligned groups (the +1 when it straddles a
    # group boundary), so the conservative worst case over a window is
    # ceil(window_cap/G) + 2R, NOT window_cap//G + R — the original budget
    # dropped candidates on fragmented windows (many short runs).  The build
    # computes the EXACT per-grid maximum for the default G (``group_cap``),
    # which is typically much tighter.
    if use_xyrow:
        gc = xyrow_caps[group]
    elif group == 8 and getattr(grid, "group_cap", 0):
        gc = grid.group_cap
    elif group == 16 and getattr(grid, "group_cap16", 0):
        gc = grid.group_cap16
    else:
        gc = -(-grid.window_cap // group) + 2 * r
    j = jnp.arange(gc, dtype=jnp.int32)[None, :]
    base = jnp.zeros((queries.shape[0], gc), jnp.int32)
    s_lane = jnp.zeros((queries.shape[0], gc), jnp.int32)
    e_lane = jnp.zeros((queries.shape[0], gc), jnp.int32)
    for c in range(r):
        inrun = (j >= excl[:, c:c + 1]) & (j < cum[:, c:c + 1])
        base = base + inrun * (gs[:, c:c + 1] - excl[:, c:c + 1])
        s_lane = s_lane + inrun * start[:, c:c + 1]
        e_lane = e_lane + inrun * end[:, c:c + 1]
    group_idx = base + j
    lane_valid = j < total[:, None]
    group_idx = jnp.where(lane_valid, jnp.minimum(group_idx, n_groups_total - 1), 0)

    gathered = table[group_idx]                          # (Qc, gc, F*G)
    qc = queries.shape[0]
    w = gc * group
    # per-feature planes: slice G contiguous columns, then merge minor dims —
    # every result is a clean (Qc, W) 2-D array
    vals = jnp.stack(
        [gathered[:, :, k * group:(k + 1) * group].reshape(qc, w)
         for k in range(f)], axis=1,
    )                                                    # (Qc, F, W)
    rep = lambda x: jnp.repeat(x, group, axis=1)         # noqa: E731
    rows = rep(group_idx * group) + jnp.tile(
        jnp.arange(group, dtype=jnp.int32), gc
    )[None, :]
    valid = rep(lane_valid) & (rows >= rep(s_lane)) & (rows < rep(e_lane))
    return vals, rows, valid


def window_distances(grid: HashGrid, queries: jnp.ndarray, group: int = 0):
    """Grouped window fetch + per-candidate distances: the shared front end
    of every no-top-k window consumer (SHOT/FPFH window paths, fused, 1-NN).

    ``group=0`` (default) uses the module default / ``set_window_group``
    override so the fetch's row-group size is A/B-able process-wide.

    Returns ``(values (Q, F, W), dist (Q, W), valid (Q, W), rows (Q, W))`` —
    ``valid`` marks true window rows (callers apply their own radius mask on
    ``dist``)."""
    vals, rows, valid = grouped_window_gather(
        grid, queries, group=group or window_group_default())
    dx = vals[:, 0, :] - queries[:, 0:1]
    dy = vals[:, 1, :] - queries[:, 1:2]
    dz = vals[:, 2, :] - queries[:, 2:3]
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return vals, dist, valid, rows


def _candidate_slots(grid: HashGrid, queries: jnp.ndarray):
    """Fallback fixed layout (27 slots x cell_cap) for table-less grids."""
    cap = grid.cell_cap
    start, end = _cell_runs(grid, queries)            # (Qc, 27)
    slots = start[..., None] + jnp.arange(cap, dtype=jnp.int32)  # (Qc, 27, cap)
    valid = slots < end[..., None]
    n = grid.packed_sorted.shape[0]
    slots = jnp.where(valid, jnp.minimum(slots, n - 1), 0)
    qc = queries.shape[0]
    return slots.reshape(qc, -1), valid.reshape(qc, -1)


def check_radius_contract(grid: HashGrid, radius) -> None:
    """Raise if a concrete ``radius`` exceeds what the grid's window covers
    (``halo * cell_size``) — a smaller cell would silently truncate
    neighborhoods.  No-op for traced radii (in-jit call sites pass the same
    host floats their grids were built with)."""
    if isinstance(radius, np.ndarray):
        radius = float(np.max(radius)) if radius.size else 0.0
    if not isinstance(radius, (int, float, np.floating)):
        return
    cell = grid.cell_size_static
    if cell is not None and grid.halo * cell < float(radius) * (1.0 - 1e-6):
        raise ValueError(
            f"grid with cell_size={cell} and halo={grid.halo} covers "
            f"radius <= {grid.halo * cell:.6g}, but the search asked for "
            f"radius={float(radius):.6g}; rebuild the grid with "
            f"cell_size >= radius / halo"
        )


def grid_radius_search(
    grid: HashGrid, queries: jnp.ndarray, radius, k_max: int,
    query_chunk: int = 512, with_values: bool = False,
):
    """Radius search through the grid (contract-checked host entry; see
    ``_grid_radius_search_jit`` for the device program)."""
    check_radius_contract(grid, radius)
    return _grid_radius_search_jit(
        grid, queries, radius, k_max, query_chunk, with_values
    )


@functools.partial(
    jax.jit, static_argnames=("k_max", "query_chunk", "with_values")
)
def _grid_radius_search_jit(
    grid: HashGrid, queries: jnp.ndarray, radius, k_max: int,
    query_chunk: int = 512, with_values: bool = False,
):
    """Radius search through the grid; same contract as
    ``neighbors.radius_search`` (requires ``halo * cell_size >= radius``).

    Returns ``Neighborhoods``, or ``(Neighborhoods, values)`` when
    ``with_values=True`` — ``values`` is (Q, k_max, 3+F) gathered
    ``[points | extras]`` rows for each neighbor (zeros where masked), taken
    from the candidate buffer already in registers (no second device memory gather).
    """
    queries = jnp.asarray(queries, jnp.float32)
    q = queries.shape[0]
    r = jnp.asarray(radius, jnp.float32)
    n_feat = grid.packed_sorted.shape[1]

    def one_chunk(qc):
        if grid.has_table:
            slots, valid = _compacted_slots(grid, qc)  # (C, window_cap)
        else:
            slots, valid = _candidate_slots(grid, qc)  # (C, 27*cap)
        cand = grid.packed_sorted[slots]               # (C, W, 3+F)
        dist = jnp.linalg.norm(cand[..., :3] - qc[:, None, :], axis=-1)
        ok = valid & (dist <= r)
        masked = jnp.where(ok, dist, jnp.inf)
        k_eff = min(k_max, masked.shape[1])
        neg, pos = jax.lax.top_k(-masked, k_eff)
        dist_k = -neg
        mask_k = jnp.isfinite(dist_k)
        idx_k = grid.orig_idx[jnp.take_along_axis(slots, pos, axis=1)]
        vals_k = jnp.take_along_axis(cand, pos[..., None], axis=1)
        vals_k = jnp.where(mask_k[..., None], vals_k, 0.0)
        if k_eff < k_max:
            pad = ((0, 0), (0, k_max - k_eff))
            idx_k = jnp.pad(idx_k, pad)
            dist_k = jnp.pad(dist_k, pad, constant_values=jnp.inf)
            mask_k = jnp.pad(mask_k, pad)
            vals_k = jnp.pad(vals_k, pad + ((0, 0),))
        out = (
            jnp.where(mask_k, idx_k, 0).astype(jnp.int32),
            jnp.where(mask_k, dist_k, jnp.inf),
            mask_k,
        )
        return out + (vals_k,) if with_values else out

    n_chunks = -(-q // query_chunk)
    padded = n_chunks * query_chunk
    qpad = jnp.pad(queries, ((0, padded - q), (0, 0)))
    out = jax.lax.map(one_chunk, qpad.reshape(n_chunks, query_chunk, 3))
    reshape = lambda x: x.reshape((padded,) + x.shape[2:])[:q]  # noqa: E731
    nbr = Neighborhoods(reshape(out[0]), reshape(out[1]), reshape(out[2]))
    if with_values:
        return nbr, reshape(out[3])
    return nbr


@functools.partial(jax.jit, static_argnames=("query_chunk",))
def grid_nearest_neighbor(grid: HashGrid, queries: jnp.ndarray, query_chunk: int = 2048):
    """1-NN through the grid.  NOTE: exact only when the true nearest neighbor
    lies within ``halo * cell_size`` of the query — callers (ICP with d_max <=
    cell_size on a halo-1 grid) satisfy this; queries with no candidate in the
    scanned window return dist=inf."""
    queries = jnp.asarray(queries, jnp.float32)
    q = queries.shape[0]

    def one_chunk(qc):
        if grid.has_table:
            # grouped feature-planar fetch: ~3x the row-gather rate
            _vals, dist, valid, rows = window_distances(grid, qc)
            masked = jnp.where(valid, dist, jnp.inf)
            pos = jnp.argmin(masked, axis=-1)
            best = jnp.take_along_axis(masked, pos[:, None], axis=1)[:, 0]
            row = jnp.take_along_axis(rows, pos[:, None], axis=1)[:, 0]
            idx = grid.orig_idx[jnp.minimum(row, grid.orig_idx.shape[0] - 1)]
            return best, idx.astype(jnp.int32)
        slots, valid = _candidate_slots(grid, qc)
        cand_pts = grid.packed_sorted[slots][..., :3]
        dist = jnp.linalg.norm(cand_pts - qc[:, None, :], axis=-1)
        masked = jnp.where(valid, dist, jnp.inf)
        pos = jnp.argmin(masked, axis=-1)
        best = jnp.take_along_axis(masked, pos[:, None], axis=1)[:, 0]
        idx = grid.orig_idx[jnp.take_along_axis(slots, pos[:, None], axis=1)[:, 0]]
        return best, idx.astype(jnp.int32)

    n_chunks = -(-q // query_chunk)
    padded = n_chunks * query_chunk
    qpad = jnp.pad(queries, ((0, padded - q), (0, 0)))
    dist, idx = jax.lax.map(one_chunk, qpad.reshape(n_chunks, query_chunk, 3))
    return dist.reshape(-1)[:q], idx.reshape(-1)[:q]


def grid_radius_pca(
    grid: HashGrid, queries: jnp.ndarray, radius, query_chunk: int = 512
):
    """Contract-checked host entry for ``_grid_radius_pca_jit``."""
    check_radius_contract(grid, radius)
    return _grid_radius_pca_jit(grid, queries, radius, query_chunk)


@functools.partial(jax.jit, static_argnames=("query_chunk",))
def _grid_radius_pca_jit(
    grid: HashGrid, queries: jnp.ndarray, radius, query_chunk: int = 512
):
    """Fused radius-neighborhood PCA: covariance/barycenter as masked
    reductions over the candidate window — no top-k, no neighborhood
    materialization, no k_max truncation (ALL in-radius points contribute,
    unlike the fixed-k search path).

    Numerics: moments accumulate on query-centered coordinates (|p - q| <=
    radius), so f32 stays accurate for clouds far from the origin.

    Returns ``(cov (Q, 3, 3), barycenter (Q, 3), count (Q,))`` with the
    reference's normalization (sum of centered outer products / count).

    ``radius`` may be a scalar or a per-query ``(Q,)`` vector (adaptive
    neighborhoods, e.g. the k-targeting normals route); every entry must obey
    the grid's ``halo * cell_size`` coverage contract.
    """
    queries = jnp.asarray(queries, jnp.float32)
    q = queries.shape[0]
    r2 = jnp.broadcast_to(jnp.asarray(radius, jnp.float32) ** 2, (q,))

    def one_chunk(args):
        qc, r2c = args
        if grid.has_table:
            slots, valid = _compacted_slots(grid, qc)
        else:
            slots, valid = _candidate_slots(grid, qc)  # binary-search fallback
        cand = grid.packed_sorted[slots][..., :3]      # (C, W, 3)
        diff = cand - qc[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        m = (valid & (d2 <= r2c[:, None])).astype(jnp.float32)
        count = jnp.sum(m, axis=-1)
        z = diff * m[..., None]
        mean_q = jnp.einsum("cwi->ci", z) / jnp.maximum(count, 1.0)[:, None]
        second = jnp.einsum("cwi,cwj->cij", z, diff)
        cov = second / jnp.maximum(count, 1.0)[:, None, None] - jnp.einsum(
            "ci,cj->cij", mean_q, mean_q
        )
        return cov, mean_q + qc, count

    n_chunks = -(-q // query_chunk)
    padded = n_chunks * query_chunk
    qpad = jnp.pad(queries, ((0, padded - q), (0, 0)))
    r2pad = jnp.pad(r2, (0, padded - q))
    cov, bary, count = jax.lax.map(
        one_chunk,
        (qpad.reshape(n_chunks, query_chunk, 3),
         r2pad.reshape(n_chunks, query_chunk)),
    )
    reshape = lambda x: x.reshape((padded,) + x.shape[2:])[:q]  # noqa: E731
    return reshape(cov), reshape(bary), reshape(count)


# Auto-dispatch threshold: below this cloud size brute force wins (one matmul
# beats build+gather); above it the compacted-candidate scan wins and scales.
AUTO_GRID_MIN_POINTS = 20_000


def radius_search_auto(queries, points, radius, k_max: int) -> Neighborhoods:
    """Pick brute force or grid-hash by cloud size (same exact contract)."""
    from .neighbors import radius_search

    points = jnp.asarray(points, jnp.float32)
    if points.shape[0] < AUTO_GRID_MIN_POINTS:
        return radius_search(queries, points, radius, k_max)
    grid = build_grid(points, float(radius))
    return grid_radius_search(grid, jnp.asarray(queries, jnp.float32), radius, k_max)


def radius_search_with_values_auto(
    queries, points, extras, radius, k_max: int, halo: int = 2
) -> tuple:
    """Radius search returning ``(Neighborhoods, values)`` where ``values`` is
    (Q, k_max, 3+F) gathered ``[points | extras]`` neighbor rows.  Large clouds
    go through the grid engine where the gather is fused into the candidate
    scan; small clouds brute-force then gather.

    ``halo=2`` (cell = radius/2, 5^3 window) trims the candidate window ~25%
    vs halo=1."""
    from .neighbors import radius_search

    points = jnp.asarray(points, jnp.float32)
    queries = jnp.asarray(queries, jnp.float32)
    extras = jnp.asarray(extras, jnp.float32)
    if points.shape[0] < AUTO_GRID_MIN_POINTS:
        nbr = radius_search(queries, points, radius, k_max)
        packed = jnp.concatenate([points, extras], axis=1)
        vals = jnp.where(nbr.mask[..., None], packed[nbr.idx], 0.0)
        return nbr, vals
    grid = build_grid(points, float(radius) / halo, extras=extras, halo=halo)
    return grid_radius_search(grid, queries, radius, k_max, with_values=True)


@functools.partial(jax.jit, static_argnames=("k",))
@functools.partial(jax.jit, static_argnames=("k",))
def kth_distance_bound(sample: jnp.ndarray, points: jnp.ndarray, k: int):
    """Per-sample k-th-neighbor distance: exact ``top_k`` over each sample's
    N-wide squared-distance row.

    The squares are of coordinate differences, not the matmul expansion: the
    bound calibrates every query's radius in the streaming normals, and the
    expansion's cancellation (~2e-4 relative at metre-scale coordinates)
    would make which points fall inside a radius, and so the normals, depend
    on how the backend rounds its dot."""
    d2 = sum((sample[:, i, None] - points[None, :, i]) ** 2 for i in range(3))
    neg, _ = jax.lax.top_k(-d2, k)
    return jnp.sqrt(-neg[:, -1])


def pad_pow2_bucket(miss: np.ndarray, min_bucket: int = 64) -> np.ndarray:
    """Pad a data-dependent miss-index set to a pow2 bucket (edge mode):
    the exactness nets' re-solve shapes would otherwise force a fresh
    compile per call.  Duplicated
    pad indices are harmless — they re-write identical values."""
    bucket = 1 << int(np.ceil(np.log2(max(len(miss), min_bucket))))
    return np.pad(miss, (0, bucket - len(miss)), mode="edge")


def quantized_kth_radius(kth: np.ndarray) -> float:
    """Search-radius bound from sampled k-th-neighbor distances: 1.5x the
    99th percentile bounds the k-th neighbor for all but sparse-region
    queries (max-based bounds blow the window up on a single outlier
    sample); quantized to a 1.25-geometric grid so repeated similar clouds
    reuse compiled query programs."""
    raw = 1.5 * float(np.quantile(np.asarray(kth), 0.99))
    return float(1.25 ** np.ceil(np.log(max(raw, 1e-12)) / np.log(1.25)))


def knn_auto(queries, points, k: int, sample_size: int = 512) -> Neighborhoods:
    """k-NN that scales to large clouds: a brute-force pass on a small sample
    bounds the k-th neighbor distance, then the grid engine searches within
    twice that bound.  Exact for all queries whose k-th neighbor lies inside
    the bound (the 2x margin over the sampled max makes misses rare; masked
    rows report fewer than k neighbors rather than wrong ones)."""
    from .neighbors import knn

    points = jnp.asarray(points, jnp.float32)
    queries = jnp.asarray(queries, jnp.float32)
    n = points.shape[0]
    if n < AUTO_GRID_MIN_POINTS:
        return knn(queries, points, k)

    stride = max(1, n // sample_size)
    sample = points[::stride][:sample_size]
    kth = np.asarray(kth_distance_bound(sample, points, k))
    radius = quantized_kth_radius(kth)
    grid = build_grid(points, radius)
    nbr = grid_radius_search(grid, queries, radius, k)
    # exactness net: queries whose k-th neighbor fell outside the bound get a
    # brute-force pass (rare — sparse regions only), keeping the k-NN contract
    missing = np.asarray(nbr.count < min(k, n))
    if missing.any():
        frac = float(missing.mean())
        if frac > 0.05:
            # heavy-tailed density: the sampled radius bound undercovers many
            # queries and this call is silently degenerating toward a full
            # brute-force pass — surface it as a diagnostic (ADVICE r1 #3)
            logger.warning(
                "knn_auto exactness net caught %.1f%% of %d queries "
                "(sampled radius bound %.3g undercovers); consider a larger "
                "sample_size or radius-based search for this cloud",
                100.0 * frac, len(missing), radius,
            )
        miss = np.nonzero(missing)[0]
        miss_pad = pad_pow2_bucket(miss)
        fix = knn(queries[miss_pad], points, k)
        # splice ON DEVICE: pulling the (N, k) neighborhood arrays to the
        # host to patch a handful of rows would move ~90 MB at 1M x 20 — a
        # device scatter of the bucket rows is free (duplicated pad indices
        # write identical values)
        mj = jnp.asarray(miss_pad)
        nbr = Neighborhoods(
            nbr.idx.at[mj].set(fix.idx),
            nbr.dist.at[mj].set(fix.dist),
            nbr.mask.at[mj].set(fix.mask),
        )
    return nbr
