"""Work split of the persistent CUDA kernels: the serving forward and
the layer step (``csrc/unroll.cu`` ``unroll_persistent``), the trajectory
forward (``traj_persistent``), the final-layer backward
(``csrc/unroll_bwd.cu`` ``bwd_chain`` and ``bwd_weights``) and the int8
serving forward (``csrc/int8_unroll.cu`` ``int8_persistent``: int32
partials, depth in bytes, ``int8_plan``).

Every phase of those kernels is one GEMM (fp32, or int8 codes into
int32) whose output is cut into 32 x 32 tiles (the fp32 serving kernel,
the fp32 trajectory and the fp32 backward chain: 32 x 32 or the wide
128 x 128, chosen by the shape; the int8 kernel: 32 x 32 or 64 x 64). A
phase with few tiles (synthetic_small at S = 64 has 16-32) also cuts its
depth into slices, so that tiles x slices work items fill the launch's
grid; each slice writes a partial tile to a workspace, and the
last block to finish a tile (counted by an integer atomic per tile) sums
the partials in slice order and runs the tile's epilogue. No float
atomics: a call repeats bit for bit on one card.

This module is the one place that decides the split: the wrappers
(``ops/cuda_unroll.py``, ``ops/cuda_layer.py``, ``ops/cuda_traj.py``,
``ops/cuda_bwd.py``, ``ops/cuda_int8.py``) compute it here and pass it to the kernels, which
decode item = tile * slices + slice (tiles row-major).
tests/test_torch_schedule.py checks, on the CPU, that this map covers
every output tile once and that the slices partition the depth. Nothing
here touches the card.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

TILE = 32  # output tile edge of every phase but the wide tile's (csrc: kT)
WIDE = 128  # the wide tile edge of the serving kernel, the fp32 trajectory and chain (csrc/wide_tile.cuh: kWT)
TILES = (TILE, WIDE)  # their tile edges (csrc: unroll_persistent<T>, traj_persistent<T>, bwd_chain<T>)
BK = 16  # depth of one shared-memory step (csrc: kBK)
MIN_STEPS = 2  # BK-deep steps a depth slice holds at least
WIDE_MIN_EDGE = 256  # m and n from which the wide tile pays for its fill (PERF.md §6, rows 1, 2 and 4)
WIDE_MIN_FLOPS = 3.5e8  # one layer's operations from which the wide tile pays for its fill (PERF.md §6, rows 1, 2 and 4)
WIDE_FILL_STEPS = 4  # BK steps an item of the wide tile costs beyond its depth
PER_SM = 2  # blocks per SM of the persistent grid when the tiles are few
ALIGN = 64  # workspace buffers start on 64-float (256-byte) boundaries


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Split(NamedTuple):
    """One phase: OUT (rows, cols) over ``depth``, cut into ``tile`` x
    ``tile`` tiles and ``slices`` depth slices of ``length`` (the last
    may be short)."""

    rows: int
    cols: int
    depth: int
    slices: int
    length: int
    tile: int = TILE

    @property
    def tiles(self) -> int:
        return cdiv(self.rows, self.tile) * cdiv(self.cols, self.tile)

    @property
    def items(self) -> int:
        return self.tiles * self.slices


def split(rows: int, cols: int, depth: int, target: int, tile: int = TILE, bk: int = BK,
          min_steps: int = MIN_STEPS) -> Split:
    """The coarsest depth split whose items reach ``target`` (the grid),
    with at least ``min_steps`` steps of ``bk`` a slice; one slice when
    the tiles alone reach it."""
    steps = cdiv(depth, bk)
    want = cdiv(target, cdiv(rows, tile) * cdiv(cols, tile))
    per = max(min_steps, cdiv(steps, max(1, want)))
    length = min(steps, per) * bk
    return Split(rows, cols, depth, cdiv(depth, length), length, tile)


def launch_grid(blocks_per_sm: int, sms: int, widest: int) -> int:
    """Blocks of a persistent launch: PER_SM a SM when the widest phase
    has fewer tiles than that (every block then meets few items, and the
    grid barrier's cost grows with the blocks), up to every resident
    block when it has more; never more than are resident (the cooperative
    launch refuses that)."""
    return min(blocks_per_sm * sms, max(sms * min(PER_SM, blocks_per_sm), widest))


# -- the trajectory forward ---------------------------------------------------


def traj_shapes(S: int, m: int, n: int) -> Dict[str, Tuple[int, int, int]]:
    """(rows, cols, depth) of each phase of one layer: x1 = prox(x - u W1^T),
    Ax1 = x1 A^T, z1 = prox(z - v W2^T)."""
    return {"x": (S, n, m), "ax": (S, m, n), "z": (S, m, m)}


def traj_schedule(S: int, m: int, n: int, blocks_per_sm: int, sms: int, tile: int = TILE):
    """(grid, {phase: Split}) of one call on ``tile`` (TILE or WIDE;
    blocks_per_sm, sms: that tile's kernel's occupancy) of the trajectory
    or of the serving kernel (``make_serve_plan``), whose phases are the
    same."""
    grid = launch_grid(blocks_per_sm, sms, widest_tiles(S, m, n, tile))
    cut = wide_split if tile == WIDE else split
    return grid, {k: cut(*v, grid, tile) for k, v in traj_shapes(S, m, n).items()}


def partial_floats(splits) -> int:
    """Floats of split-K partials one phase needs at most (0 unsplit)."""
    return max([sp.items * sp.tile * sp.tile for sp in splits if sp.slices > 1] or [0])


def traj_workspace(S: int, m: int, n: int, splits: Dict[str, Split],
                   bf16_state: bool = False) -> Dict[str, Tuple[int, int]]:
    """{buffer: (offset, floats)} of the trajectory's workspace: on the 32
    tile the zero state of layer 0, on the wide tile instead its operands u
    and v, (S, m) each (its layer 0 reads no zero state); the partials and
    one int32 counter per tile. With ``bf16_state`` (bf16 storage, 32 tile
    only, csrc/unroll.cu) also the fp32 state the layers pass on
    unrounded: x (S, n), Ax (S, m), and z and lam, two (S, m) buffers
    each."""
    first = {"u": S * m, "v": S * m} if splits["x"].tile == WIDE else {"zeros": S * max(n, m)}
    state = {"x": S * n, "ax": S * m, "z": 2 * S * m, "lam": 2 * S * m} if bf16_state else {}
    return layout({
        **first,
        "partials": partial_floats(splits.values()),
        "counters": max(sp.tiles for sp in splits.values()),
        **state,
    })


def layout(sizes: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
    """Offsets, in 4-byte words from the workspace's start, of buffers
    packed in the given order, each on an ALIGN boundary; '_total' holds
    the words to allocate."""
    out, off = {}, 0
    for name, count in sizes.items():
        out[name] = (off, count)
        off += cdiv(count, ALIGN) * ALIGN
    out["_total"] = (off, 0)
    return out


# -- the serving forward and the layer step -------------------------------------


def widest_tiles(S: int, m: int, n: int, tile: int) -> int:
    """Output tiles of the widest phase of one layer at this tile edge."""
    return max(cdiv(r, tile) * cdiv(c, tile) for r, c, _ in traj_shapes(S, m, n).values())


def wide_fits(m: int, n: int, vec: int) -> bool:
    """Whether the wide tile's 16-byte staging can read these rows:
    m and n whole chunks of ``vec`` elements (4 fp32, 8 bf16; 0: the
    caller's tensors do not start on 16 bytes). csrc/unroll.cu
    wide_layout holds the same rule and refuses others."""
    return vec > 0 and m % vec == 0 and n % vec == 0


def tile_edge(S: int, m: int, n: int, vec: int = 4) -> int:
    """The tile of the serving kernel, of the fp32 trajectory and of the
    fp32 backward chain (csrc/unroll.cu unroll_persistent<T>,
    traj_persistent<T>, csrc/unroll_bwd.cu bwd_chain<T>), one rule for
    the three, whose phases share the wide mainloop (the chain's with its
    weight staged by depth) and its fixed cost a layer: WIDE
    where its 16-byte staging fits (``wide_fits``), m and n are
    WIDE_MIN_EDGE or more, S is TILE or more (below, the wide tile
    computes 4x the rows or more for the same answer) and one layer's
    three products hold WIDE_MIN_FLOPS or more (the wide tile's fill,
    split-K reduction and epilogue cost about 80-115 us a layer, which a
    smaller layer's faster mainloop does not pay back). Else 32, whose
    depth slices fill the card at every serving bucket. Measured on the
    H100 (PERF.md §6, rows 1 and 2), wide / 32 tile in ms, trajectory |
    serving forward: synthetic_large S = 32 2.37 / 2.23 | 2.19 / 2.11,
    S = 40 2.28 / 2.83 | 2.43 / 2.76, S = 1024 7.37 / 22.42 | 7.79 / 22.47;
    512 x 1024 S = 128 1.55 / 1.38 | 1.72 / 1.50, S = 256 1.34 / 1.91 |
    1.49 / 2.06; 256 x 512 S = 512 1.22 / 1.24 | 1.42 / 1.32; tp_large
    S = 16 45.4 / 44.0 | 45.1 / 43.9, S = 32 (serving) 46.0 / 48.0, S = 64
    46.9 / 94.3 | 45.8 / 95.7, S = 256 94.8 / 384.7 | 94.3 / 388.5.
    The chain's three products, gp2 W2, gAx1 A and gp1 W1, hold as many
    operations a layer; the whole backward call, wide / 32 tile chain, in
    ms (PERF.md §6, row 4): synthetic_large S = 16 2.46 / 2.29, S = 32
    2.49 / 2.57, S = 40 2.91 / 3.37, S = 1024 18.49 / 32.38; 512 x 1024
    S = 128 1.97 / 1.79, S = 256 2.07 / 2.60; 256 x 512 S = 512 1.66 /
    1.65, S = 1024 2.15 / 2.16; 128 x 256 S = 1024 1.46 / 1.24; tp_large
    S = 16 64.1 / 62.3, S = 32 72.6 / 73.8, S = 256 273.2 / 536.5. bf16
    storage passes ``vec`` 0 for the chain, which has no wide bf16
    instantiation."""
    flops = 2 * S * m * (2 * n + m)  # one layer: x (S,m)x(m,n), Ax (S,n)x(n,m), z (S,m)x(m,m)
    big = S >= TILE and flops >= WIDE_MIN_FLOPS and min(m, n) >= WIDE_MIN_EDGE
    return WIDE if big and wide_fits(m, n, vec) else TILE


def int8_tile(S: int, m: int, n: int, occ64: Tuple[int, int]) -> int:
    """The int8 kernel's tile: 64 where the widest phase's 64 x 64 tiles
    alone reach every resident block of its 64-tile kernel (occ64: its
    blocks a SM, SMs), so that the larger tile's fewer loads a flop cost
    no idle SMs; else 32."""
    return 64 if widest_tiles(S, m, n, 64) >= occ64[0] * occ64[1] else 32


def wide_split(rows: int, cols: int, depth: int, grid: int, tile: int = WIDE, bk: int = BK) -> Split:
    """The wide tile's depth split: the slice count whose items take the
    least time on ``grid`` blocks, counting each item as its BK steps plus
    WIDE_FILL_STEPS (the ring's fill, the reduction and the epilogue) and
    each wave of items in full; the fewer slices on a tie."""
    steps = cdiv(depth, bk)
    tiles = cdiv(rows, tile) * cdiv(cols, tile)
    best = min(range(1, steps + 1),
               key=lambda s: (cdiv(tiles * s, grid) * (cdiv(steps, s) + WIDE_FILL_STEPS), s))
    length = cdiv(steps, best) * bk
    return Split(rows, cols, depth, cdiv(depth, length), length, tile)


class ServePlan(NamedTuple):
    """One call of a serving kernel (fp32 or int8): the launched
    instantiation's occupancy (blocks a SM, SMs), its grid, {phase: Split}
    (all on one tile edge) and {buffer: (offset, floats)} of its
    workspace."""

    occ: Tuple[int, int]
    grid: int
    splits: Dict[str, Split]
    workspace: Dict[str, Tuple[int, int]]

    @property
    def tile(self) -> int:
        return self.splits["x"].tile


def serve_workspace(S: int, m: int, n: int, splits: Dict[str, Split], scratch: bool,
                    bf16_state: bool = False) -> Dict[str, Tuple[int, int]]:
    """{buffer: (offset, words)}: with ``scratch`` (the serving forward)
    the second z / lam pair and Ax, (S, m) each; the split-K partials and
    one int32 counter per tile of the widest split phase (none unsplit).
    With ``bf16_state`` (bf16 storage, csrc/unroll.cu) the z / lam pair is
    bf16 (half the words), and the workspace also holds the fp32 Ax (S, m)
    and x (S, n) that the layers' phases pass on unrounded, for the
    serving forward and the layer step alike. On the wide tile, also the
    fp32 operands u and v of the x and z phases, (S, m) each (empty on the
    32 tile)."""
    sm = S * m if scratch else 0
    sizes = {"z_tmp": sm, "lam_tmp": sm, "ax": sm}
    if bf16_state:
        sizes = {"z_tmp": cdiv(sm, 2), "lam_tmp": cdiv(sm, 2), "ax": S * m, "x": S * n}
    uv = S * m if splits["x"].tile == WIDE else 0
    return layout({
        **sizes,
        "u": uv,
        "v": uv,
        "partials": partial_floats(splits.values()),
        "counters": max([sp.tiles for sp in splits.values() if sp.slices > 1] or [0]),
    })


def make_serve_plan(S: int, m: int, n: int, occ32: Tuple[int, int], occ_wide: Tuple[int, int], scratch: bool,
                    bf16_state: bool = False, vec: int = 4, tile: int = 0) -> ServePlan:
    """The plan of one serving-kernel call (``tile`` 0: tile_edge's
    choice at ``vec``, the elements of a 16-byte chunk of the call's
    storage, 0 where its tensors do not start on 16 bytes); occ32 /
    occ_wide are the two tile kernels' occupancy (of the instantiation of
    the call's storage and staging). A forced WIDE tile where its staging
    does not fit raises ValueError."""
    tile = tile or tile_edge(S, m, n, vec)
    if tile == WIDE and not wide_fits(m, n, vec):
        raise ValueError(f"the wide tile stages 16-byte chunks of {vec or '(misaligned)'} elements; "
                         f"m={m}, n={n} do not fit")
    occ = occ_wide if tile == WIDE else occ32
    grid, splits = traj_schedule(S, m, n, *occ, tile)
    return ServePlan(occ, grid, splits, serve_workspace(S, m, n, splits, scratch, bf16_state))


@functools.lru_cache(maxsize=64)
def serve_plan(S: int, m: int, n: int, occ32: Tuple[int, int], occ_wide: Tuple[int, int], scratch: bool,
               bf16_state: bool = False, vec: int = 4) -> ServePlan:
    """make_serve_plan, computed once per shape and occupancy, so a call
    pays no Python for it."""
    return make_serve_plan(S, m, n, occ32, occ_wide, scratch, bf16_state, vec)


def serve_barriers(K: int, tile: int) -> int:
    """Grid barriers of one call of the serving kernel or the trajectory:
    barriers(K), and on the wide tile one more, after the phase that
    writes layer 0's u."""
    return barriers(K) + (tile == WIDE)


# -- int8 serving ----------------------------------------------------------------

INT8_TILES = (32, 64)  # the int8 kernel's tile edges (csrc/int8_unroll.cu: int8_persistent<T>)
INT8_BK = 64  # bytes of depth of one staging step, two m16n8k32 steps (csrc: kBK)
INT8_BUFFERS = ("u", "v", "ax", "amax", "partials", "counters")


def int8_barriers(K: int) -> int:
    """Grid barriers of one int8 call: after the first phase (layer 0's u)
    and between the three phases of every layer."""
    return 3 * K


def int8_workspace(S: int, m: int, splits: Dict[str, Split]) -> Dict[str, Tuple[int, int]]:
    """{buffer: (offset, words)}: the fp32 u, v and Ax (S, m) each; the
    three row-maxima vectors (3S ints); the int32 split-K partials of the
    largest split phase (items x tile x tile); a counter a tile of the
    widest split phase (none unsplit). csrc/int8_unroll.cu lay_out holds
    the same rules and refuses others."""
    sm = S * m
    return layout({
        "u": sm, "v": sm, "ax": sm, "amax": 3 * S,
        "partials": partial_floats(splits.values()),
        "counters": max([sp.tiles for sp in splits.values() if sp.slices > 1] or [0]),
    })


def int8_split(rows: int, cols: int, depth: int, slices: int, tile: int) -> Split:
    """``depth`` cut into about ``slices`` slices of whole INT8_BK steps
    (fewer where the steps run out)."""
    steps = cdiv(depth, INT8_BK)
    length = cdiv(steps, max(1, min(slices, steps))) * INT8_BK
    return Split(rows, cols, depth, cdiv(depth, length), length, tile)


def make_int8_plan(S: int, m: int, n: int, occ: Tuple[Tuple[int, int], ...], tile: int = 0,
                   slices: int = 0) -> ServePlan:
    """The plan of one int8 call (its splits' depth in bytes, slices of
    whole INT8_BK steps; its workspace in INT8_BUFFERS order, in 4-byte
    words). ``occ``: (blocks a SM, SMs) of each INT8_TILES kernel.
    ``tile`` 0 takes int8_tile's rule (64 where its tiles alone fill the
    64 kernel's resident blocks); ``slices`` 0 cuts each phase's depth as
    ``split`` does for the grid, else into about that many slices (a
    forced choice, for the card tests)."""
    tile = tile or int8_tile(S, m, n, occ[INT8_TILES.index(64)])
    o = occ[INT8_TILES.index(tile)]
    shapes = traj_shapes(S, m, n)
    grid = launch_grid(*o, max(cdiv(r, tile) * cdiv(c, tile) for r, c, _ in shapes.values()))
    if slices:
        splits = {k: int8_split(*v, slices, tile) for k, v in shapes.items()}
    else:
        splits = {k: split(*v, grid, tile, INT8_BK, 1) for k, v in shapes.items()}
    return ServePlan(o, grid, splits, int8_workspace(S, m, splits))


@functools.lru_cache(maxsize=64)
def int8_plan(S: int, m: int, n: int, occ: Tuple[Tuple[int, int], ...]) -> ServePlan:
    """make_int8_plan, computed once per shape and occupancy, so a call
    pays no Python for it."""
    return make_int8_plan(S, m, n, occ)


# -- the final-layer backward ---------------------------------------------------


def bwd_shapes(S: int, m: int, n: int) -> Dict[str, Tuple[int, int, int]]:
    """(rows, cols, depth) of each chain phase of one layer: gv = -gp2 W2,
    gp1 from gAx1 A, gu = -gp1 W1."""
    return {"v": (S, m, m), "x": (S, n, m), "u": (S, m, n)}


def weight_tiles(m: int, n: int) -> int:
    """Output tiles of one layer's weight gradients: 32-row tiles of gW1
    (n rows) then of gW2 (m rows), 32-column tiles of their m columns."""
    return (cdiv(n, TILE) + cdiv(m, TILE)) * cdiv(m, TILE)


class WeightSplit(NamedTuple):
    """The weight-gradient launch: K layers of weight_tiles(m, n) tiles,
    each summed over S in ``slices`` slices of ``bs`` rows."""

    S: int
    m: int
    n: int
    K: int
    bs: int

    @property
    def slices(self) -> int:
        return cdiv(self.S, self.bs)

    @property
    def tiles(self) -> int:
        return self.K * weight_tiles(self.m, self.n)

    @property
    def items(self) -> int:
        return self.tiles * self.slices


def bwd_schedule(S: int, m: int, n: int, K: int, bs: int, blocks_per_sm: int, sms: int, tile: int = TILE):
    """(grid of the chain, {phase: Split}, WeightSplit) of one backward
    call on the chain's ``tile`` (TILE or WIDE; blocks_per_sm, sms: that
    tile's chain kernel's occupancy); bs >= S is the whole batch. The
    weight launch keeps its 32 tiles."""
    shapes = bwd_shapes(S, m, n)
    widest = max(cdiv(r, tile) * cdiv(c, tile) for r, c, _ in shapes.values())
    grid = launch_grid(blocks_per_sm, sms, widest)
    cut = wide_split if tile == WIDE else split
    return grid, {k: cut(*v, grid, tile) for k, v in shapes.items()}, WeightSplit(S, m, n, K, min(bs, S))


BWD_BUFFERS = ("gz", "glam", "gax", "gv", "gax1", "zeros", "gp1", "gp2", "th1p", "th2p", "betap",
               "partials", "counters", "gb")


def bwd_workspace(S: int, m: int, n: int, K: int, splits: Dict[str, Split], wsplit: WeightSplit,
                  data_grads: bool, bf16: bool = False) -> Dict[str, Tuple[int, int]]:
    """{buffer: (offset, floats)} of the backward's workspace, in
    BWD_BUFFERS order (csrc/unroll_bwd.cu reads the pointers in it): the
    cotangent carries, this layer's gv and gAx1 (the caller's stack with
    data_grads), the zero state, the gp1 (K, S, n) and gp2 (K, S, m)
    stacks the weight gradients read, the gth1/gth2 column partials per
    row block of the chain's tile (32 or 128 rows), two gbeta partials
    (fp64) per U tile, the split-K partials of the chain or of the weight
    launch, and the counters.
    With ``bf16`` (bf16 storage) gAx1 is always the fp32 buffer here (the
    caller's stack is its rounded copy), and gb's fp32 accumulator is too
    (with data_grads)."""
    sm = S * m
    nrb = cdiv(S, splits["x"].tile)
    wpart = wsplit.items * TILE * TILE if wsplit.slices > 1 else 0
    return layout({
        "gz": sm, "glam": sm, "gax": sm, "gv": sm, "gax1": 0 if data_grads and not bf16 else sm, "zeros": sm,
        "gp1": K * S * n, "gp2": K * sm,
        "th1p": K * nrb * n, "th2p": K * nrb * m,
        "betap": K * splits["u"].tiles * 4,
        "partials": max(partial_floats(splits.values()), wpart),
        "counters": max(max(sp.tiles for sp in splits.values()), wsplit.tiles),
        "gb": sm if data_grads and bf16 else 0,
    })


@functools.lru_cache(maxsize=64)
def traj_plan(S: int, m: int, n: int, blocks_per_sm: int, sms: int, bf16_state: bool = False,
              tile: int = TILE):
    """(grid, splits, workspace) of one trajectory call on ``tile``
    (``tile_edge``'s choice), computed once per shape, so a training step
    pays no Python for it."""
    grid, sp = traj_schedule(S, m, n, blocks_per_sm, sms, tile)
    return grid, sp, traj_workspace(S, m, n, sp, bf16_state)


@functools.lru_cache(maxsize=64)
def bwd_plan(S: int, m: int, n: int, K: int, bs: int, data_grads: bool, blocks_per_sm: int, sms: int,
             bf16: bool = False, tile: int = TILE):
    """(grid, splits, weight split, workspace) of one backward call on
    the chain's ``tile`` (``tile_edge``'s choice), cached as traj_plan."""
    grid, sp, wsplit = bwd_schedule(S, m, n, K, bs, blocks_per_sm, sms, tile)
    return grid, sp, wsplit, bwd_workspace(S, m, n, K, sp, wsplit, data_grads, bf16)


def barriers(K: int) -> int:
    """Grid barriers a call of any of the kernels waits at: three phases
    a layer, none after the last (the backward's weight and finish
    launches follow its chain kernel on the stream)."""
    return 3 * K - 1


__all__ = [
    "ALIGN", "BK", "BWD_BUFFERS", "INT8_BK", "INT8_BUFFERS", "INT8_TILES", "MIN_STEPS", "PER_SM", "ServePlan", "Split", "TILE", "TILES", "WIDE", "WIDE_FILL_STEPS", "WIDE_MIN_EDGE", "WIDE_MIN_FLOPS", "WeightSplit",
    "barriers", "bwd_plan", "int8_barriers", "int8_plan", "int8_split", "int8_tile", "int8_workspace", "make_int8_plan", "bwd_schedule", "bwd_shapes", "bwd_workspace", "cdiv", "launch_grid",
    "layout", "make_serve_plan", "partial_floats", "serve_barriers", "serve_plan", "serve_workspace", "split",
    "tile_edge", "traj_plan", "traj_schedule", "traj_shapes", "traj_workspace", "weight_tiles", "wide_fits", "wide_split", "widest_tiles",
]
