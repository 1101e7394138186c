"""The work split of the persistent CUDA kernels (ops/schedule.py), on
the CPU: the serving forward's and the layer step's x, Ax and z phases
(32 or wide 128 tiles, chosen by the shape and the grid), the trajectory forward's and the
final-layer backward's V, X, U chain and its weight-gradient launch. ``items`` and
``weight_items`` below decode a work item as the kernels do, and
``test_kernels_decode_items_as_these_tests_do`` holds that decode to the
kernels' source, so these checks hold for what runs on the card: every
output tile is covered exactly once, the depth slices partition the
depth, the workspace's buffers do not overlap, and at training's S = 64
every phase spreads over the grid. The kernels themselves are held
against their plain versions by tests/test_torch_cuda.py (``gpu``) and
chip_smoke.py.
"""

import itertools

import pytest

from dladmm_tpu_torch.ops import cuda_build
from dladmm_tpu_torch.ops import schedule as sch

# The kernels' decode of item ``it`` (csrc/unroll.cu traj_phase and
# serve_phase, csrc/unroll_bwd.cu chain_phase and bwd_weights), line for
# line.
CHAIN_DECODE = ("const int tile = it / sp.slices, s = it % sp.slices;",
                "const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);")
SERVE_DECODE = ("const int ct = dcdiv(N, T), items = dcdiv(S, T) * ct * sp.slices;",
                "const int tile = it / sp.slices, s = it % sp.slices;",
                "const int row0 = tile / ct * T, col0 = tile % ct * T;",
                "const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);")
WIDE_DECODE = ("const int ct = dcdiv(N, kWT), items = dcdiv(S, kWT) * ct * sp.slices;",
               "const int tile = it / sp.slices, s = it % sp.slices;",
               "const int row0 = tile / ct * kWT, col0 = tile % ct * kWT;",
               "const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);")
WIDE_CHAIN_DECODE = ("const int rt = dcdiv(S, kWT), ct = dcdiv(N, kWT), items = rt * ct * sp.slices;",
                     "const int tile = it / sp.slices, s = it % sp.slices;",
                     "const int rb = tile / ct, row0 = rb * kWT, col0 = tile % ct * kWT;",
                     "const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);")
WEIGHT_DECODE = ("const int tile = it / slices, s = it % slices;",
                 "const int k = tile / per, t = tile % per, rt = t / ct, cb = t % ct;",
                 "const int rows = w1 ? n : m, row0 = (w1 ? rt : rt - t1) * kT, col0 = cb * kT;",
                 "const int s_lo = s * a.bs, s_hi = min(S, s_lo + a.bs);")


def items(sp: sch.Split):
    """(row0, col0, k_lo, k_hi) of every work item of a phase in index
    order, decoded as CHAIN_DECODE and SERVE_DECODE (tiles row-major, of
    the split's tile edge)."""
    ct = -(-sp.cols // sp.tile)
    for it in range(sp.items):
        tile, s = divmod(it, sp.slices)
        k_lo = s * sp.length
        yield tile // ct * sp.tile, tile % ct * sp.tile, k_lo, min(sp.depth, k_lo + sp.length)


def weight_items(ws: sch.WeightSplit):
    """(layer, "gW1" or "gW2", row0, col0, s_lo, s_hi) of every item of
    the weight-gradient launch in index order, decoded as WEIGHT_DECODE."""
    t1, ct = -(-ws.n // sch.TILE), -(-ws.m // sch.TILE)
    per = sch.weight_tiles(ws.m, ws.n)
    for it in range(ws.items):
        tile, s = divmod(it, ws.slices)
        k, t = divmod(tile, per)
        rt, cb = divmod(t, ct)
        w1 = rt < t1
        s_lo = s * ws.bs
        yield (k, "gW1" if w1 else "gW2", (rt if w1 else rt - t1) * sch.TILE, cb * sch.TILE,
               s_lo, min(ws.S, s_lo + ws.bs))


@pytest.mark.parametrize("source,lines", [("unroll.cu", CHAIN_DECODE), ("unroll_bwd.cu", CHAIN_DECODE),
                                          ("unroll_bwd.cu", WEIGHT_DECODE), ("unroll.cu", SERVE_DECODE),
                                          ("unroll.cu", WIDE_DECODE), ("unroll_bwd.cu", WIDE_CHAIN_DECODE)])
def test_kernels_decode_items_as_these_tests_do(source, lines):
    """The decode ``items`` and ``weight_items`` mirror stands in the
    kernel's source, so a change to the kernels' map fails here."""
    text = " ".join((cuda_build.CSRC / source).read_text().split())
    for line in lines:
        assert line in text, f"{source} no longer decodes items as: {line}"

# (m, n, S): synthetic_small at training, serving and the fused step's
# batch, synthetic_large, and ragged small shapes.
SHAPES = [(250, 500, 1), (250, 500, 64), (250, 500, 256), (250, 500, 1024), (250, 500, 3000),
          (1000, 2000, 1024), (33, 77, 13), (16, 32, 8)]
# (blocks a SM, SMs): the H100's occupancy of either kernel, and a small card.
CARDS = [(4, 132), (3, 132), (1, 8)]


def _check_split(sp: sch.Split):
    tiles = {}
    for row0, col0, k_lo, k_hi in items(sp):
        assert 0 <= row0 < sp.rows and 0 <= col0 < sp.cols
        assert row0 % sp.tile == 0 and col0 % sp.tile == 0
        assert 0 <= k_lo < k_hi <= sp.depth
        tiles.setdefault((row0, col0), []).append((k_lo, k_hi))
    rows = range(0, sp.rows, sp.tile)
    cols = range(0, sp.cols, sp.tile)
    assert set(tiles) == set(itertools.product(rows, cols))  # every tile, once
    for slices in tiles.values():
        assert len(slices) == sp.slices
        # the slices, in order, partition [0, depth): no gap, no overlap
        assert slices[0][0] == 0 and slices[-1][1] == sp.depth
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        # every slice but the last holds whole steps of BK
        assert all((hi - lo) % sch.BK == 0 for lo, hi in slices[:-1])


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("m,n,S", SHAPES)
def test_trajectory_items_cover_every_tile_once(m, n, S, card):
    grid, splits = sch.traj_schedule(S, m, n, *card)
    assert 1 <= grid <= card[0] * card[1]
    assert set(splits) == {"x", "ax", "z"}
    for name, sp in splits.items():
        assert (sp.rows, sp.cols, sp.depth) == sch.traj_shapes(S, m, n)[name]
        _check_split(sp)


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("m,n,S", SHAPES)
def test_backward_chain_items_cover_every_tile_once(m, n, S, card):
    grid, splits, wsplit = sch.bwd_schedule(S, m, n, 3, S, *card)
    assert 1 <= grid <= card[0] * card[1]
    assert set(splits) == {"v", "x", "u"}
    for name, sp in splits.items():
        assert (sp.rows, sp.cols, sp.depth) == sch.bwd_shapes(S, m, n)[name]
        _check_split(sp)
    assert wsplit.slices == 1


@pytest.mark.parametrize("m,n,S,K,bs", [(250, 500, 64, 15, 64), (250, 500, 1024, 2, 128), (33, 77, 13, 5, 4),
                                        (16, 32, 8, 4, 8), (32, 64, 1024, 4, 128), (33, 77, 13, 2, 5)])
def test_weight_items_cover_every_gradient_tile_once(m, n, S, K, bs):
    """Each (layer, gW1 / gW2 tile) once, its S slices of bs rows in
    order partitioning [0, S)."""
    ws = sch.WeightSplit(S, m, n, K, bs)
    seen = {}
    for k, which, row0, col0, s_lo, s_hi in weight_items(ws):
        rows = n if which == "gW1" else m
        assert 0 <= k < K and 0 <= row0 < rows and 0 <= col0 < m
        seen.setdefault((k, which, row0, col0), []).append((s_lo, s_hi))
    want = {(k, w, r, c) for k in range(K) for w, rows in (("gW1", n), ("gW2", m))
            for r in range(0, rows, sch.TILE) for c in range(0, m, sch.TILE)}
    assert set(seen) == want and len(want) == ws.tiles
    for slices in seen.values():
        assert slices == [(lo, min(S, lo + bs)) for lo in range(0, S, bs)]


def test_every_phase_spreads_over_the_card_at_batch_64():
    """synthetic_small S = 64 on the H100 (4 trajectory and 3 backward
    blocks a SM): 264 blocks, and every phase has at least about one item
    a SM, though it has only 16-32 output tiles."""
    grid, splits = sch.traj_schedule(64, 250, 500, 4, 132)
    assert grid == 264
    assert {k: sp.tiles for k, sp in splits.items()} == {"x": 32, "ax": 16, "z": 16}
    assert all(sp.items >= 128 for sp in splits.values())
    grid, splits, wsplit = sch.bwd_schedule(64, 250, 500, 15, 64, 3, 132)
    assert grid == 264
    assert all(sp.items >= 128 for sp in splits.values())
    assert wsplit.items == 2880  # 15 layers x 192 tiles of gW1 and gW2
    # many tiles: one slice, and every resident block
    grid, splits = sch.traj_schedule(3000, 250, 500, 4, 132)
    assert grid == 528 and all(sp.slices == 1 for sp in splits.values())


def test_launch_grid_is_never_more_than_resident():
    assert sch.launch_grid(4, 132, 16) == 132 * sch.PER_SM
    assert sch.launch_grid(4, 132, 300) == 300
    assert sch.launch_grid(4, 132, 10**6) == 528
    assert sch.launch_grid(1, 132, 16) == 132


def _no_overlap(lay, words):
    spans = sorted((off, off + count) for name, (off, count) in lay.items() if name != "_total")
    assert all(off % sch.ALIGN == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= lay["_total"][0] == words


@pytest.mark.parametrize("m,n,S", SHAPES)
def test_trajectory_workspace(m, n, S):
    grid, splits = sch.traj_schedule(S, m, n, 4, 132)
    lay = sch.traj_workspace(S, m, n, splits)
    parts = max([sp.items * sch.TILE**2 for sp in splits.values() if sp.slices > 1] or [0])
    want = {"zeros": S * max(n, m), "partials": parts, "counters": max(sp.tiles for sp in splits.values())}
    assert {k: v[1] for k, v in lay.items() if k != "_total"} == want
    _no_overlap(lay, sum(-(-v // sch.ALIGN) * sch.ALIGN for v in want.values()))
    assert sch.traj_plan(S, m, n, 4, 132) == (grid, splits, lay)


@pytest.mark.parametrize("data_grads", [True, False])
@pytest.mark.parametrize("m,n,S,K,bs", [(250, 500, 64, 15, 64), (250, 500, 1024, 15, 128), (1000, 2000, 1024, 20, 1024),
                                        (33, 77, 13, 5, 4)])
def test_backward_workspace(m, n, S, K, bs, data_grads):
    """Every buffer the kernel reads from the workspace, in BWD_BUFFERS
    order; the gp1 / gp2 stacks K deep; partials for the larger of the
    chain's split-K and the weight launch's S slices."""
    grid, splits, wsplit = sch.bwd_schedule(S, m, n, K, bs, 3, 132)
    lay = sch.bwd_workspace(S, m, n, K, splits, wsplit, data_grads)
    assert tuple(k for k in lay if k != "_total") == sch.BWD_BUFFERS
    assert lay["gp1"][1] == K * S * n and lay["gp2"][1] == K * S * m
    assert lay["gax1"][1] == (0 if data_grads else S * m)
    assert lay["betap"][1] == K * splits["u"].tiles * 4
    chain = max([sp.items * sch.TILE**2 for sp in splits.values() if sp.slices > 1] or [0])
    weights = wsplit.items * sch.TILE**2 if wsplit.slices > 1 else 0
    assert lay["partials"][1] == max(chain, weights)
    assert lay["counters"][1] >= max(wsplit.tiles, *(sp.tiles for sp in splits.values()))
    _no_overlap(lay, lay["_total"][0])
    assert sch.bwd_plan(S, m, n, K, bs, data_grads, 3, 132)[3] == lay


def test_stacks_cost_what_the_design_says():
    """gp1 + gp2 stacks: 2.9 MB at synthetic_small S = 64, 245 MB at
    synthetic_large S = 1024."""
    def stacks(m, n, S, K):
        grid, splits, wsplit = sch.bwd_schedule(S, m, n, K, S, 3, 132)
        lay = sch.bwd_workspace(S, m, n, K, splits, wsplit, True)
        return 4 * (lay["gp1"][1] + lay["gp2"][1]) / 1e6

    assert stacks(250, 500, 64, 15) == pytest.approx(2.88)
    assert stacks(1000, 2000, 1024, 20) == pytest.approx(245.76)


def test_plan_is_computed_once_per_shape():
    """A training step pays no Python for the split: the same shape and
    occupancy give the very same plan object; another shape another."""
    one = sch.traj_plan(64, 250, 500, 4, 132)
    assert sch.traj_plan(64, 250, 500, 4, 132) is one
    assert sch.traj_plan(65, 250, 500, 4, 132) is not one
    two = sch.bwd_plan(64, 250, 500, 15, 64, False, 3, 132)
    assert sch.bwd_plan(64, 250, 500, 15, 64, False, 3, 132) is two
    assert sch.bwd_plan(64, 250, 500, 15, 64, True, 3, 132) is not two


def test_barriers_per_call():
    assert sch.barriers(15) == 44


# -- the serving forward and the layer step ------------------------------------

# (m, n, S): SHAPES, and S = 1 at the ragged and the synthetic_large widths.
SERVE_SHAPES = SHAPES + [(33, 77, 1), (1000, 2000, 1)]
# Shapes the wide tile's 16-byte staging takes (m and n multiples of 4):
# synthetic_large at ragged batches, the patch shape, small multiples.
WIDE_SHAPES = [(1000, 2000, 1), (1000, 2000, 129), (1000, 2000, 1000), (1000, 2000, 1024),
               (64, 256, 961), (16, 32, 8), (128, 256, 256)]
# The workspace of the serving forward (scratch) and of the layer step.
KINDS = {"unroll_forward": True, "layer_step": False}
# The InferenceServer's buckets.
BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]


def serve_cards(card):
    """(occ32, occ_wide) of a card of CARDS: the 32 tile's blocks a SM,
    and a quarter of them (at least one) for the wide tile (8 x 8 outputs
    a thread: one block a SM on the H100)."""
    bps, sms = card
    return (bps, sms), (max(1, bps // 4), sms)


def _check_serve_plan(plan, S, m, n, tile, occ32, occ_wide):
    assert plan.tile == tile and plan.occ == (occ_wide if tile == sch.WIDE else occ32)
    assert 1 <= plan.grid <= plan.occ[0] * plan.occ[1]
    assert set(plan.splits) == {"x", "ax", "z"}
    for name, sp in plan.splits.items():
        assert (sp.rows, sp.cols, sp.depth) == sch.traj_shapes(S, m, n)[name]
        assert sp.tile == tile
        _check_split(sp)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("m,n,S", SERVE_SHAPES + WIDE_SHAPES)
def test_serving_items_cover_every_tile_once(m, n, S, card, kind):
    """At both tile edges: every output tile of each phase once, the
    slices partitioning the depth, the grid within the launched
    kernel's resident blocks. The wide tile where its staging fits;
    forced elsewhere it is refused."""
    occ32, occ_wide = serve_cards(card)
    for tile in sch.TILES:
        if tile == sch.WIDE and not sch.wide_fits(m, n, 4):
            with pytest.raises(ValueError, match="16-byte"):
                sch.make_serve_plan(S, m, n, occ32, occ_wide, KINDS[kind], tile=tile)
            continue
        plan = sch.make_serve_plan(S, m, n, occ32, occ_wide, KINDS[kind], tile=tile)
        _check_serve_plan(plan, S, m, n, tile, occ32, occ_wide)


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("m,n,S", SERVE_SHAPES + WIDE_SHAPES)
def test_serving_tile_is_64_exactly_where_its_tiles_fill_the_card(m, n, S, card):
    """The large tile (now the wide 128 tile) exactly where its staging
    fits, S >= 32, m, n >= 256 and a layer holds WIDE_MIN_FLOPS operations
    (where it measured faster than the 32 tile, PERF.md); the grid then
    every resident block of the wide kernel (its tiles and depth slices
    fill them)."""
    occ32, occ_wide = serve_cards(card)
    big = S >= 32 and 2 * S * m * (2 * n + m) >= sch.WIDE_MIN_FLOPS and min(m, n) >= 256
    want = 128 if m % 4 == 0 and n % 4 == 0 and big else 32
    assert sch.tile_edge(S, m, n) == want
    plan = sch.make_serve_plan(S, m, n, occ32, occ_wide, True)
    assert plan.tile == want
    if want == 128:
        assert plan.grid == occ_wide[0] * occ_wide[1]


def test_serving_tile_on_the_h100_shapes():
    """With 4 blocks a SM at the 32 tile and 1 at the wide one on 132
    SMs (the H100's occupancy): synthetic_small takes the 32 tile at every
    serving bucket (1 to 1024; m = 250 is no multiple of 4);
    synthetic_large at S = 1024 takes the wide tile (128 tiles in the x
    phase, one item each on 132 blocks; Ax and z two depth slices of 64
    tiles)."""
    occ32, occ_wide = (4, 132), (1, 132)
    for S in BUCKETS:
        assert sch.serve_plan(S, 250, 500, occ32, occ_wide, True).tile == 32
    plan = sch.serve_plan(1024, 1000, 2000, occ32, occ_wide, True)
    assert plan.tile == 128 and plan.grid == 132 and plan.splits["x"].tiles == 128
    assert {k: (sp.slices, sp.items) for k, sp in plan.splits.items()} == {
        "x": (1, 128), "ax": (2, 128), "z": (2, 128)}
    small = sch.serve_plan(256, 250, 500, occ32, occ_wide, True)
    assert small.grid == 264 and all(sp.items >= 256 for sp in small.splits.values())


@pytest.mark.parametrize("bf16_state", [False, True])
@pytest.mark.parametrize("S", BUCKETS)
def test_wide_tile_at_synthetic_large_buckets(S, bf16_state):
    """synthetic_large (m = 1000, n = 2000: whole 16-byte chunks of fp32
    and of bf16) takes the wide tile at S = 1024 and at every bucket above
    32, where it measured faster than the 32 tile; the 32 tile from 32
    down, where the wide tile's fill costs more than its mainloop saves."""
    plan = sch.serve_plan(S, 1000, 2000, (4, 132), (1, 132), True, bf16_state, 8 if bf16_state else 4)
    assert plan.tile == (128 if S > 32 else 32)
    if S == 1024:
        assert plan.tile == 128


@pytest.mark.parametrize("vec", [4, 8])
@pytest.mark.parametrize("S", BUCKETS)
def test_synthetic_small_keeps_tile_32(S, vec):
    """The paper's 250 x 500 stays on the 32 tile at every bucket, in
    either storage."""
    assert sch.tile_edge(S, 250, 500, vec) == 32
    assert sch.serve_plan(S, 250, 500, (4, 132), (1, 132), True, vec == 8, vec).tile == 32


@pytest.mark.parametrize("m,n,vec,fits", [(1000, 2000, 4, True), (1000, 2000, 8, True), (1002, 2000, 4, False),
                                          (1000, 2002, 4, False), (1004, 2000, 8, False), (1000, 2004, 8, False),
                                          (1004, 2004, 4, True), (1000, 2000, 0, False)])
def test_wide_tile_falls_back_where_rows_do_not_fit(m, n, vec, fits):
    """m or n not whole 16-byte chunks (4 fp32, 8 bf16), or weights that
    do not start on 16 bytes (vec 0): the 32 tile, even at S = 1024."""
    assert sch.wide_fits(m, n, vec) == fits
    assert sch.tile_edge(1024, m, n, vec) == (128 if fits else 32)
    plan = sch.make_serve_plan(1024, m, n, (4, 132), (1, 132), True, vec == 8, vec=vec)
    assert plan.tile == (128 if fits else 32)


@pytest.mark.parametrize("m,n,S", SERVE_SHAPES + WIDE_SHAPES + [(1000, 2000, S) for S in BUCKETS])
def test_int8_tile_is_unchanged(m, n, S):
    """make_int8_plan keeps its own rule: 64 where the widest phase's 64 x
    64 tiles alone reach every resident block of its 64 kernel, else 32,
    whatever the fp32 kernel's wide tile does."""
    occ = ((4, 132), (2, 132))
    widest64 = max(-(-r // 64) * -(-c // 64) for r, c, _ in sch.traj_shapes(S, m, n).values())
    want = 64 if widest64 >= 2 * 132 else 32
    assert sch.int8_tile(S, m, n, occ[1]) == want
    assert sch.make_int8_plan(S, m, n, occ).tile == want


@pytest.mark.parametrize("grid", [264, 132, 8])
@pytest.mark.parametrize("m,n,S", WIDE_SHAPES)
def test_wide_split_takes_the_fewest_waves(m, n, S, grid):
    """The wide tile's split: whole BK steps a slice, at most one wave
    more than the least any split needs, and no split with the same
    number of waves of shorter items under it."""
    for rows, cols, depth in sch.traj_shapes(S, m, n).values():
        sp = sch.wide_split(rows, cols, depth, grid)
        _check_split(sp)
        steps = -(-depth // sch.BK)
        cost = lambda s: -(-sp.tiles * s // grid) * (-(-steps // s) + sch.WIDE_FILL_STEPS)  # noqa: E731
        assert all(cost(sp.slices) <= cost(s) for s in range(1, steps + 1))


def test_serving_barriers():
    """3K - 1 barriers on the 32 tile; one more on the wide tile (after
    the phase that writes layer 0's u)."""
    assert sch.serve_barriers(20, 32) == 59 and sch.serve_barriers(20, 128) == 60


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,S", SERVE_SHAPES + WIDE_SHAPES)
def test_serving_workspace(m, n, S, kind):
    """The serving forward's scratch (z_tmp, lam_tmp, Ax: (S, m) each;
    none for the layer step, which writes fresh outputs), the wide tile's
    operands u and v ((S, m) each, both kinds; none on the 32 tile),
    partials for the largest split phase at its tile edge, a counter per
    tile of the widest split phase (none when no phase splits)."""
    for tile in sch.TILES:
        if tile == sch.WIDE and not sch.wide_fits(m, n, 4):
            continue
        plan = sch.make_serve_plan(S, m, n, (4, 132), (2, 132), KINDS[kind], tile=tile)
        lay = plan.workspace
        split = [sp for sp in plan.splits.values() if sp.slices > 1]
        scratch = S * m if KINDS[kind] else 0
        uv = S * m if tile == sch.WIDE else 0
        want = {"z_tmp": scratch, "lam_tmp": scratch, "ax": scratch, "u": uv, "v": uv,
                "partials": max([sp.items * tile**2 for sp in split] or [0]),
                "counters": max([sp.tiles for sp in split] or [0])}
        assert {k: v[1] for k, v in lay.items() if k != "_total"} == want
        _no_overlap(lay, sum(-(-v // sch.ALIGN) * sch.ALIGN for v in want.values()))


def test_serving_plan_is_computed_once_per_shape():
    one = sch.serve_plan(256, 250, 500, (4, 132), (2, 132), True)
    assert sch.serve_plan(256, 250, 500, (4, 132), (2, 132), True) is one
    assert sch.serve_plan(256, 250, 500, (4, 132), (2, 132), False) is not one
    assert one == sch.make_serve_plan(256, 250, 500, (4, 132), (2, 132), True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,S", SERVE_SHAPES + WIDE_SHAPES)
def test_serving_workspace_on_bf16_state(m, n, S, kind):
    """bf16 storage (csrc/unroll.cu, unroll_persistent<T, BF16,
    __nv_bfloat16>): the serving forward's second z / lam pair in bf16
    (half the words), and for the serving forward and the layer step alike
    the fp32 Ax (S, m) and x (S, n) that the phases pass on unrounded, and
    on the wide tile the fp32 u and v; the tiles, grid and splits are the
    fp32 plan's at the same occupancy."""
    for tile in sch.TILES:
        if tile == sch.WIDE and not sch.wide_fits(m, n, 8):
            continue
        plan = sch.make_serve_plan(S, m, n, (4, 132), (2, 132), KINDS[kind], True, tile=tile, vec=8)
        fp32 = sch.make_serve_plan(S, m, n, (4, 132), (2, 132), KINDS[kind], tile=tile)
        assert (plan.occ, plan.grid, plan.splits) == (fp32.occ, fp32.grid, fp32.splits)
        lay = plan.workspace
        split = [sp for sp in plan.splits.values() if sp.slices > 1]
        pair = -(-S * m // 2) if KINDS[kind] else 0
        uv = S * m if tile == sch.WIDE else 0
        want = {"z_tmp": pair, "lam_tmp": pair, "ax": S * m, "x": S * n, "u": uv, "v": uv,
                "partials": max([sp.items * tile**2 for sp in split] or [0]),
                "counters": max([sp.tiles for sp in split] or [0])}
        assert {k: v[1] for k, v in lay.items() if k != "_total"} == want
        _no_overlap(lay, sum(-(-v // sch.ALIGN) * sch.ALIGN for v in want.values()))


def test_bf16_serving_plan_is_its_own_cache_entry():
    one = sch.serve_plan(256, 250, 500, (4, 132), (2, 132), True, True)
    assert sch.serve_plan(256, 250, 500, (4, 132), (2, 132), True, True) is one
    assert one.workspace != sch.serve_plan(256, 250, 500, (4, 132), (2, 132), True).workspace
    assert one == sch.make_serve_plan(256, 250, 500, (4, 132), (2, 132), True, True)


def test_wide_tile_constants_match_the_kernel():
    """The wide tile's edge and step depth in csrc/wide_tile.cuh are the
    plan's, and the kernel's launch checks the plan's layout rule."""
    text = " ".join((cuda_build.CSRC / "wide_tile.cuh").read_text().split())
    assert f"constexpr int kWT = {sch.WIDE};" in text and f"constexpr int kWBK = {sch.BK};" in text
    unroll = " ".join((cuda_build.CSRC / "unroll.cu").read_text().split())
    assert "constexpr int vec = 16 / sizeof(TS);" in unroll and "a.m % vec == 0 && a.n % vec == 0" in unroll
    # the trajectory's wide instantiation: the same tile, and the same
    # layout rule checked before its launch
    assert "traj_persistent<kWT, TS>" in unroll and "if (tile == kWT && !wide_layout(traj_layer(a, 0)))" in unroll


# -- the trajectory on the wide tile --------------------------------------------

# (S, m, n, vec, tile): synthetic_large at the training cells' S = 1024
# and at S = 64, tp_large at its batch 256, at 64 and at 32, 512 x 1024 at
# 256, 256 x 512 at 1024, where the wide tile measured faster;
# synthetic_large at S = 32, tp_large at S = 16 (under one 32-row tile),
# 512 x 1024 at 128 and
# tp_small's 256 x 512 at its batch 128 (too few operations a layer),
# where the 32 tile measured faster or would; synthetic_small (m = 250, no
# whole 16-byte chunk of fp32 or bf16), the image benchmark's 64 x 256
# (under WIDE_MIN_EDGE), tensors that do not start on 16 bytes (vec 0).
TRAJ_TILES = [(1024, 1000, 2000, 4, 128), (256, 8192, 16384, 4, 128), (64, 1000, 2000, 4, 128), (32, 8192, 16384, 4, 128),
              (64, 8192, 16384, 4, 128), (256, 512, 1024, 4, 128), (1024, 256, 512, 4, 128),
              (32, 1000, 2000, 4, 32), (16, 8192, 16384, 4, 32), (128, 512, 1024, 4, 32), (128, 256, 512, 4, 32),
              (64, 250, 500, 4, 32), (3844, 64, 256, 4, 32), (1024, 250, 500, 8, 32), (1024, 1000, 2000, 0, 32)]


@pytest.mark.parametrize("S,m,n,vec,tile", TRAJ_TILES)
def test_trajectory_tile(S, m, n, vec, tile):
    """tile_edge takes the wide tile where its 16-byte staging fits, m
    and n are 256 or more, S is 32 or more and a layer
    holds WIDE_MIN_FLOPS operations, else 32; its plan on the H100's
    occupancy of that tile's kernel (4 blocks a SM at 32, 1 wide) is on
    that tile in every phase."""
    assert sch.tile_edge(S, m, n, vec) == tile
    occ = (1, 132) if tile == sch.WIDE else (4, 132)
    grid, splits, _ = sch.traj_plan(S, m, n, *occ, tile=tile)
    assert grid <= occ[0] * occ[1] and all(sp.tile == tile for sp in splits.values())


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("m,n,S", WIDE_SHAPES + [(8192, 16384, 256)])
def test_wide_trajectory_items_cover_every_tile_once(m, n, S, card):
    """On the wide tile (the wide kernel's occupancy, serve_cards): every
    output tile of each phase once, the slices partitioning the depth in
    whole BK steps, the serving plan's grid and splits at that tile."""
    occ32, occ_wide = serve_cards(card)
    grid, splits = sch.traj_schedule(S, m, n, *occ_wide, sch.WIDE)
    serve = sch.make_serve_plan(S, m, n, occ32, occ_wide, False, tile=sch.WIDE)
    assert (grid, splits) == (serve.grid, serve.splits)
    for name, sp in splits.items():
        assert sp.tile == sch.WIDE and (sp.rows, sp.cols, sp.depth) == sch.traj_shapes(S, m, n)[name]
        _check_split(sp)


@pytest.mark.parametrize("S,m,n,slices", [(1024, 1000, 2000, {"x": 1, "ax": 2, "z": 2}),
                                          (256, 8192, 16384, {"x": 1, "ax": 1, "z": 1})])
def test_wide_trajectory_splits_on_the_h100(S, m, n, slices):
    """One wide block a SM on 132 SMs: synthetic_large at S = 1024 splits
    Ax and z in two (64 tiles each), as row 1 there; tp_large at S = 256
    (256, 128 and 128 tiles of depth 8192-16384) splits no phase, nor does
    the 32 tile there (2048-4096 tiles on 528 blocks), so both sum each
    output over the whole depth in order."""
    grid, splits = sch.traj_schedule(S, m, n, 1, 132, sch.WIDE)
    assert grid == 132 and {k: sp.slices for k, sp in splits.items()} == slices
    if S == 256:
        assert {k: sp.tiles for k, sp in splits.items()} == {"x": 256, "ax": 128, "z": 128}
        assert all(sp.slices == 1 for sp in sch.traj_schedule(S, m, n, 4, 132)[1].values())


@pytest.mark.parametrize("bf16_state", [False, True])
@pytest.mark.parametrize("m,n,S", WIDE_SHAPES + [(8192, 16384, 256)])
def test_trajectory_workspace_by_tile(m, n, S, bf16_state):
    """The wide tile's workspace holds its operands u and v, (S, m) each,
    and no zero state; the 32 tile's the zero state and no u or v. Partials
    at the phases' own tile edge, the bf16 state on the 32 tile only (bf16
    storage keeps it), no overlap; traj_plan returns the same."""
    for tile in sch.TILES:
        if tile == sch.WIDE and bf16_state:
            continue
        grid, splits = sch.traj_schedule(S, m, n, 4 if tile == sch.TILE else 1, 132, tile)
        lay = sch.traj_workspace(S, m, n, splits, bf16_state)
        first = {"u": S * m, "v": S * m} if tile == sch.WIDE else {"zeros": S * max(n, m)}
        state = {"x": S * n, "ax": S * m, "z": 2 * S * m, "lam": 2 * S * m} if bf16_state else {}
        want = {**first, **state,
                "partials": max([sp.items * tile**2 for sp in splits.values() if sp.slices > 1] or [0]),
                "counters": max(sp.tiles for sp in splits.values())}
        assert {k: v[1] for k, v in lay.items() if k != "_total"} == want
        _no_overlap(lay, sum(-(-v // sch.ALIGN) * sch.ALIGN for v in want.values()))
        occ = (4, 132) if tile == sch.TILE else (1, 132)
        assert sch.traj_plan(S, m, n, *occ, bf16_state, tile) == (grid, splits, lay)


@pytest.mark.parametrize("tile,per_layer,first", [(32, 3, 0), (128, 3, 1)])
def test_trajectory_barriers(tile, per_layer, first):
    """3K - 1 grid barriers a trajectory call on the 32 tile, 3K on the
    wide tile (one after the phase that writes layer 0's u): the kernel's
    loops as ``serve_barriers`` counts them."""
    K = 20
    assert sch.serve_barriers(K, tile) == first + per_layer * K - 1
    text = " ".join((cuda_build.CSRC / "unroll.cu").read_text().split())
    body = text[text.index("traj_persistent(const TrajArgs<TS> a) {"):text.index("// A wide-tile instantiation")]
    branch = body.split("} else {")[tile == sch.WIDE]
    assert branch.count("grid.sync();") == per_layer + first
    assert branch.count("if (k + 1 < a.K) grid.sync();") == 1


# -- the backward chain on the wide tile ----------------------------------------

# (S, m, n, vec, tile): the chain's tile (schedule.tile_edge, the rule of
# rows 1 and 2) at the benchmark's training shapes (tp_large at its batch
# 256, synthetic_large at 1024: wide) and at the small ones:
# synthetic_small (m = 250, no whole 16-byte chunk), the image
# benchmark's 64 x 256 patches (under WIDE_MIN_EDGE), tp_small's 256 x
# 512 at its batch 128 (too few operations a layer), tp_large at S = 16
# (under one 32-row tile), bf16 storage (vec 0: no wide chain) and
# tensors that do not start on 16 bytes.
CHAIN_TILES = [(256, 8192, 16384, 4, 128), (1024, 1000, 2000, 4, 128), (64, 1000, 2000, 4, 128),
               (64, 250, 500, 4, 32), (1024, 250, 500, 4, 32), (3844, 64, 256, 4, 32), (128, 256, 512, 4, 32),
               (16, 8192, 16384, 4, 32), (256, 8192, 16384, 0, 32), (1024, 1000, 2000, 0, 32)]


@pytest.mark.parametrize("S,m,n,vec,tile", CHAIN_TILES)
def test_chain_tile(S, m, n, vec, tile):
    """The chain takes the wide tile where its 16-byte staging fits, m
    and n are 256 or more, S is 32 or more and a layer's three chain
    products (as many operations as the forward's three) hold
    WIDE_MIN_FLOPS, else 32; its plan on the H100's occupancy of that
    tile's chain (4 blocks a SM at 32, 1 wide) is on that tile in every
    phase, the weight launch on 32 tiles whatever the chain's."""
    assert sch.tile_edge(S, m, n, vec) == tile
    big = S >= 32 and 2 * S * m * (m + 2 * n) >= sch.WIDE_MIN_FLOPS and min(m, n) >= 256
    assert tile == (128 if big and sch.wide_fits(m, n, vec) else 32)
    occ = (1, 132) if tile == sch.WIDE else (4, 132)
    grid, splits, wsplit, _ = sch.bwd_plan(S, m, n, 2, S, False, *occ, tile=tile)
    assert grid <= occ[0] * occ[1] and all(sp.tile == tile for sp in splits.values())
    assert wsplit.tiles == 2 * sch.weight_tiles(m, n)


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("m,n,S", WIDE_SHAPES + [(8192, 16384, 256)])
def test_wide_chain_items_cover_every_tile_once(m, n, S, card):
    """On the wide tile (the wide chain's occupancy, serve_cards): every
    output tile of the V, X and U phases once, the slices partitioning the
    depth in whole BK steps, each split the wide tile's (wide_split)."""
    _, occ_wide = serve_cards(card)
    grid, splits, wsplit = sch.bwd_schedule(S, m, n, 3, S, *occ_wide, sch.WIDE)
    assert 1 <= grid <= occ_wide[0] * occ_wide[1]
    for name, sp in splits.items():
        assert sp.tile == sch.WIDE and (sp.rows, sp.cols, sp.depth) == sch.bwd_shapes(S, m, n)[name]
        assert sp == sch.wide_split(*sch.bwd_shapes(S, m, n)[name], grid)
        _check_split(sp)
    assert wsplit == sch.WeightSplit(S, m, n, 3, S)


@pytest.mark.parametrize("S,m,n,slices", [(256, 8192, 16384, {"v": 1, "x": 1, "u": 1}),
                                          (1024, 1000, 2000, {"v": 2, "x": 1, "u": 2})])
def test_wide_chain_splits_on_the_h100(S, m, n, slices):
    """One wide block a SM on 132 SMs: tp_large at S = 256 splits no phase
    (128, 256 and 128 tiles of depth 8192-16384), nor does the 32 tile
    there, so both sum each output over the whole depth in order;
    synthetic_large at S = 1024 splits V and U in two (64 tiles each)."""
    grid, splits, _ = sch.bwd_schedule(S, m, n, 20, S, 1, 132, sch.WIDE)
    assert grid == 132 and {k: sp.slices for k, sp in splits.items()} == slices
    if S == 256:
        assert {k: sp.tiles for k, sp in splits.items()} == {"v": 128, "x": 256, "u": 128}
        assert all(sp.slices == 1 for sp in sch.bwd_schedule(S, m, n, 20, S, 4, 132)[1].values())


@pytest.mark.parametrize("tile", sch.TILES)
@pytest.mark.parametrize("m,n,S,K", [(8192, 16384, 256, 20), (1000, 2000, 1024, 20), (1000, 2000, 64, 3),
                                     (128, 256, 200, 2)])
def test_backward_workspace_by_tile(m, n, S, K, tile):
    """The gth1 / gth2 column partials one per row block of the chain's
    tile (cdiv(S, 128) on the wide tile, cdiv(S, 32) on the 32 tile, as
    finish reads them), the gbeta pairs one per U tile, the split-K
    partials at the chain's tile edge; no overlap; bwd_plan returns the
    same."""
    occ = (1, 132) if tile == sch.WIDE else (4, 132)
    grid, splits, wsplit = sch.bwd_schedule(S, m, n, K, S, *occ, tile)
    lay = sch.bwd_workspace(S, m, n, K, splits, wsplit, False)
    nrb = -(-S // tile)
    assert lay["th1p"][1] == K * nrb * n and lay["th2p"][1] == K * nrb * m
    assert lay["betap"][1] == K * splits["u"].tiles * 4 == K * nrb * -(-m // tile) * 4
    assert lay["partials"][1] == max([sp.items * tile**2 for sp in splits.values() if sp.slices > 1] or [0])
    _no_overlap(lay, lay["_total"][0])
    assert sch.bwd_plan(S, m, n, K, S, False, *occ, tile=tile)[3] == lay


def test_wide_chain_launch_matches_the_plan():
    """The kernel's tile comes from the plan's sched array (its eighth
    int), its 16-byte layout rule is checked before anything is enqueued,
    and finish reads the partials of the chain's own row blocks."""
    text = " ".join((cuda_build.CSRC / "unroll_bwd.cu").read_text().split())
    assert "const int grid = sched[0], tile = sched[7];" in text
    assert "if (tile == kWT && !wide_chain_layout(c)) return (int)cudaErrorInvalidValue;" in text
    assert "const int nrb = cdiv(S, tile)" in text and "nrb * cdiv(m, tile));" in text
    assert "c.m % 4 == 0 && c.n % 4 == 0" in text
