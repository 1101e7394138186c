"""The int8 serving kernel's plan and premises, on the CPU (no JAX, no
card): ``ops/schedule.int8_plan`` (tiles, depth slices, grid, workspace,
barriers), the two facts its bit-equality rests on (a row's max |.| as
the max of the floats' int bits; the code of a quantized element by a
reciprocal product with the division near half-integers), and the
wrapper's argument shaping (``ops/cuda_int8.kernel_args``). The kernel
itself is held against its plain version bit for bit on the card
(tests/test_torch_cuda.py, ``gpu``; chip_smoke.py phase 18).
"""

import re

import numpy as np
import pytest
import torch

from dladmm_tpu_torch.models.unroll import init_dladmm_params
from dladmm_tpu_torch.ops import cuda_build, cuda_int8
from dladmm_tpu_torch.ops import schedule as sch
from dladmm_tpu_torch.ops.quantized import quantize_params

SRC = (cuda_build.CSRC / "int8_unroll.cu").read_text()
# (m, n, K): the two presets and odd widths (rows of 37 and 75 bytes).
WIDTHS = [(250, 500, 15), (1000, 2000, 20), (37, 75, 3)]
BATCHES = [1, 13, 64, 256, 1024]
# (blocks a SM, SMs) of the 32 and the 64 tile kernel: the H100's (2 and 2), others.
CARDS = [((2, 132), (2, 132)), ((4, 132), (2, 132)), ((1, 8), (1, 8))]


def _items(sp: sch.Split):
    """(row0, col0, k_lo, k_hi) of every item, decoded as int8_phase does."""
    ct = -(-sp.cols // sp.tile)
    for it in range(sp.items):
        tile, s = divmod(it, sp.slices)
        k_lo = s * sp.length
        yield tile // ct * sp.tile, tile % ct * sp.tile, k_lo, min(sp.depth, k_lo + sp.length)


def _check_plan(plan: sch.ServePlan, S: int, m: int, n: int):
    assert 1 <= plan.grid <= plan.occ[0] * plan.occ[1]
    assert set(plan.splits) == {"x", "ax", "z"}
    for name, sp in plan.splits.items():
        assert (sp.rows, sp.cols, sp.depth) == sch.traj_shapes(S, m, n)[name]
        assert sp.tile == plan.tile and sp.length % sch.INT8_BK == 0 and sp.length >= sch.INT8_BK
        # the slices partition the depth, each a whole number of 64-byte steps
        assert sp.slices == -(-sp.depth // sp.length)
        seen = {}
        for row0, col0, k_lo, k_hi in _items(sp):
            assert row0 < S and col0 < sp.cols and k_lo < k_hi
            seen.setdefault((row0, col0), []).append((k_lo, k_hi))
        # every output tile exactly once, its slices covering the depth in order
        want = {(r, c) for r in range(0, S, sp.tile) for c in range(0, sp.cols, sp.tile)}
        assert set(seen) == want
        for spans in seen.values():
            assert spans[0][0] == 0 and spans[-1][1] == sp.depth
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _no_overlap(lay):
    spans = sorted((off, off + cnt) for name, (off, cnt) in lay.items() if name != "_total")
    assert all(off % sch.ALIGN == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= lay["_total"][0]


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("S", BATCHES)
@pytest.mark.parametrize("m,n,K", WIDTHS)
def test_int8_plan_covers_every_tile_once(m, n, K, S, card):
    """The plan the wrapper launches with: every output tile of each phase
    once, slices of whole 64-byte steps partitioning the depth, a grid the
    launched tile kernel holds resident, a workspace whose buffers do not
    overlap, and 3K barriers."""
    plan = sch.int8_plan(S, m, n, card)
    _check_plan(plan, S, m, n)
    assert plan.occ == card[sch.INT8_TILES.index(plan.tile)]
    _no_overlap(plan.workspace)
    assert sch.int8_barriers(K) == 3 * K


@pytest.mark.parametrize("slices", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("tile", sch.INT8_TILES)
@pytest.mark.parametrize("S", [1, 13, 256])
@pytest.mark.parametrize("m,n,K", WIDTHS)
def test_forced_int8_plans_are_plans(m, n, K, S, tile, slices):
    """Every tile and depth split the card tests force is a valid plan:
    the kernel runs any of them bit for bit."""
    plan = sch.make_int8_plan(S, m, n, CARDS[0], tile=tile, slices=slices)
    assert plan.tile == tile
    _check_plan(plan, S, m, n)
    _no_overlap(plan.workspace)
    if slices:
        assert all(sp.slices <= slices for sp in plan.splits.values())


@pytest.mark.parametrize("S", BATCHES)
@pytest.mark.parametrize("m,n,K", WIDTHS)
def test_int8_workspace(m, n, K, S):
    """u, v, Ax (S x m floats each), 3S row maxima, the int32 partials of
    the largest split phase (an item a tile x tile) and a counter a tile
    of the widest split phase (none unsplit)."""
    plan = sch.int8_plan(S, m, n, CARDS[0])
    split = [sp for sp in plan.splits.values() if sp.slices > 1]
    want = {"u": S * m, "v": S * m, "ax": S * m, "amax": 3 * S,
            "partials": max([sp.items * plan.tile ** 2 for sp in split] or [0]),
            "counters": max([sp.tiles for sp in split] or [0])}
    assert {k: v[1] for k, v in plan.workspace.items() if k != "_total"} == want
    assert tuple(k for k in plan.workspace if k != "_total") == sch.INT8_BUFFERS


def test_int8_plan_on_the_h100_shapes():
    """synthetic_small takes the 32 tile at every serving bucket and fills
    the grid with depth slices (256 items a phase at S = 256); synthetic_large
    at S = 1024 the 64 tile (512 tiles in the x phase, every resident
    block)."""
    occ = CARDS[0]
    for S in (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024):
        assert sch.int8_plan(S, 250, 500, occ).tile == 32
    small = sch.int8_plan(256, 250, 500, occ)
    assert small.grid == 264 and all(sp.items == 256 for sp in small.splits.values())
    large = sch.int8_plan(1024, 1000, 2000, occ)
    assert large.tile == 64 and large.grid == 264 and large.splits["x"].tiles == 512
    assert sch.int8_plan(256, 250, 500, occ) is small  # computed once per shape


def test_kernel_holds_the_plans_rules():
    """The kernel's C side decodes items, steps the depth and lays out its
    workspace as the plan does: the decode lines, the step and alignment
    constants and the buffer order stand in csrc/int8_unroll.cu."""
    text = " ".join(SRC.split())
    for line in ("const int ct = dcdiv(N, T), items = dcdiv(S, T) * ct * sp.slices;",
                 "const int tile = it / sp.slices, s = it % sp.slices;",
                 "const int row0 = tile / ct * T, col0 = tile % ct * T;",
                 "const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);",
                 f"constexpr int kBK = {sch.INT8_BK};", f"constexpr int kAlign = {sch.ALIGN};"):
        assert line in text, line
    for tile in sch.INT8_TILES:
        assert f"if (tile == {tile}) return (const void*)int8_persistent<{tile}>;" in text
    enum = re.search(r"enum Buffer \{([^}]*)\}", SRC).group(1)
    names = [w.strip().split()[0][4:].lower() for w in enum.split(",")]
    assert tuple(names[:-1]) == sch.INT8_BUFFERS and names[-1] == "total"
    assert "const long long words = tiles * sp[p].slices * tile * tile;" in text
    assert "__dp4a" not in SRC and "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in SRC


def _edge_floats():
    """fp32 rows with zeros, -0.0, denormals, ties and the extremes."""
    rng = np.random.default_rng(0)
    tiny = np.float32(np.finfo(np.float32).tiny)
    special = np.array([0.0, -0.0, tiny, -tiny, tiny / 8, -tiny / 8, np.float32(1e-45), -np.float32(1e-45),
                        1.0, -1.0, 3.5, -3.5, np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32)
    rows = [special, np.zeros(7, np.float32), -np.zeros(7, np.float32), np.full(5, -2.25, np.float32),
            np.array([2.25, -2.25, 2.25], np.float32), (rng.normal(size=(64,)) * 1e-40).astype(np.float32)]
    rows += [(rng.normal(size=(rng.integers(1, 300),)) * 10.0 ** rng.integers(-30, 30)).astype(np.float32)
             for _ in range(200)]
    return rows


def test_row_max_of_the_int_bits_is_the_float_max():
    """The premise of the epilogues' atomicMax: for |v| (sign cleared), the
    int32 order of the bits is the float order, so the max of the bits is
    the bits of abs().amax() -- zeros, -0.0, denormals and ties included."""
    for row in _edge_floats():
        t = torch.from_numpy(row).abs()
        got = t.view(torch.int32).max()
        assert int(got) == int(t.amax().view(torch.int32)), row[:8]
        assert int(got) >= 0


def _code_by_reciprocal(v: np.ndarray, den: np.ndarray) -> np.ndarray:
    """csrc/int8_unroll.cu code(): q = v * rcp(den), both rounded to fp32;
    within kNearHalf of a half-integer the correctly rounded division."""
    near = np.float32(2.0 ** -14)
    q = (v * (np.float32(1.0) / den)).astype(np.float32)
    f = np.abs(q - np.rint(q))
    return np.where(f > np.float32(0.5) - near, np.rint(v / den), np.rint(q)).astype(np.int32)


def test_code_by_reciprocal_is_the_code_by_division():
    """The kernel's quantization equals the plain version's rint(v / den)
    (den = max(max|row| * (1/127), 1e-12), all fp32) for random rows of
    every scale, zero rows, denormal rows and values placed at and beside
    the half-integers of the quotient."""
    rng = np.random.default_rng(1)
    inv127, tiny = np.float32(1.0 / 127.0), np.float32(1e-12)
    total = 0
    for scale in [1e-42, 1e-38, 1e-20, 1e-12, 1e-10, 1e-6, 1e-2, 1.0, 3.0, 1e3, 1e10, 1e30]:
        v = (rng.uniform(-1, 1, size=(64, 512)) * scale).astype(np.float32)
        amax = np.abs(v).max(axis=1, keepdims=True)
        den = np.maximum((amax * inv127).astype(np.float32), tiny)
        # quotients at and one to eight ulps beside k + 1/2
        k = rng.integers(-127, 127, size=(64, 256)).astype(np.float32) + np.float32(0.5)
        halves = (k * den).astype(np.float32)
        for step in range(-8, 9):
            h = halves
            for _ in range(abs(step)):
                h = np.nextafter(h, np.float32(np.inf) if step > 0 else np.float32(-np.inf))
            h = np.clip(h, -amax, amax)
            v2 = np.concatenate([v, h], axis=1)
            assert np.array_equal(_code_by_reciprocal(v2, den), np.rint(v2 / den).astype(np.int32))
            total += v2.size
    assert total > 10 ** 6
    assert f"constexpr float kNearHalf = 1.0f / {2 ** 14}.0f;" in SRC


def _quantized(m, n, K, S, scalar_theta):
    rng = np.random.default_rng(m + S)
    A = torch.as_tensor(rng.normal(size=(m, n)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(S, m)).astype(np.float32))
    return b, *quantize_params(init_dladmm_params(A, K=K, per_coordinate=not scalar_theta), A)


@pytest.mark.parametrize("scalar_theta", [False, True])
def test_kernel_args_copy_nothing(scalar_theta):
    """(K, 1) thresholds become (K, n) / (K, m) views with column stride 0
    and a (K, 1) beta a (K,) view: the kernel reads them through their
    strides, so no argument is copied."""
    b, qp, qd = _quantized(16, 32, 3, 5, scalar_theta)
    if scalar_theta:
        qp = qp._replace(beta=qp.beta.reshape(3, 1))
    args = cuda_int8.kernel_args(b, qp, qd)
    names = ("b", "A_q", "A_s", "W1_q", "W1_s", "W2_q", "W2_s", "theta1", "theta2", "beta")
    given = (b, qd.A_q, qd.A_s, qp.W1_q, qp.W1_s, qp.W2_q, qp.W2_s, qp.theta1, qp.theta2, qp.beta)
    for name, got, src in zip(names, args, given):
        assert got.data_ptr() == src.data_ptr(), name
    th1, th2, beta = args[-3:]
    assert th1.shape == (3, 32) and th2.shape == (3, 16) and beta.shape == (3,)
    assert th1.stride() == ((1, 0) if scalar_theta else (32, 1))
    assert th2.stride() == ((1, 0) if scalar_theta else (16, 1))


def test_kernel_args_raise_on_what_the_kernel_does_not_take():
    b, qp, qd = _quantized(16, 32, 3, 5, False)
    with pytest.raises(ValueError, match="W2_q"):
        cuda_int8.kernel_args(b, qp._replace(W2_q=qp.W2_q[:, :8]), qd)
    with pytest.raises(TypeError, match="W1_q"):
        cuda_int8.kernel_args(b, qp._replace(W1_q=qp.W1_q.to(torch.int32)), qd)
    with pytest.raises(TypeError, match="b is"):
        cuda_int8.kernel_args(b.double(), qp, qd)
    with pytest.raises(TypeError, match="theta1"):
        cuda_int8.kernel_args(b, qp._replace(theta1=qp.theta1.double()), qd)
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_int8.kernel_args(b, qp._replace(W1_s=qp.W1_s.t().contiguous().t()), qd)
    with pytest.raises(ValueError, match="S >= 1"):
        cuda_int8.kernel_args(b[:0], qp, qd)
