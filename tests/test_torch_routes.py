"""The inference route table (models/api.inference_forward) as its
callers see it, on the CPU (the kernels' plain versions).

For every kernel, served type, B (identity "I" or general "B") and prox
pair (l1/l1, or prox_x nonneg_l1 or group_l2 with prox_z l1): the route
InferenceServer names, or the ValueError it raises. Where the server
serves an l1 or prox net at B = I in fp32 or bf16, DLADMMSolver.solve
(_paths) names the same route, or raises the same error (its own rule
aside: kernel="pallas" with a prox is l1/l1-only there), and
bench/serving.measure's route column holds it."""

import re

import pytest
import torch

from dladmm_tpu_torch import serve
from dladmm_tpu_torch.bench import serving
from dladmm_tpu_torch.models.solver import DLADMMSolver
from dladmm_tpu_torch.models.unroll import init_dladmm_params
from dladmm_tpu_torch.ops import prox as tprox

M, N, K, BUCKET = 8, 16, 2, 4

PAIRS = {
    "l1": None,
    "nonneg_l1": (tprox.get_prox("nonneg_l1"), tprox.prox_l1),
    "group_l2": (tprox.get_prox("group_l2"), tprox.prox_l1),
}

INT8_B = ValueError(
    "dtype='int8' requires identity B (the quantized forward specializes to B = I like the kernels)"
)
INT8_PROX = ValueError(
    "dtype='int8' serving is l1/l1-only (ops/quantized.py hard-codes the shrink); serve general-prox solvers in "
    "float32 or bfloat16"
)
INT8_PALLAS = ValueError(
    "dtype='int8' serves via ops/quantized.py; kernel='pallas' does not apply (use one of ('auto', 'megakernel', "
    "'reference'))"
)
PROX_B = ValueError("prox_pair requires identity B (the kernel specializes B = I); pass step_fn for general B")
B_MEGAKERNEL = ValueError("kernel='megakernel' requires identity B; general-B serving runs the plain loop")
B_PALLAS = ValueError("kernel='pallas' requires identity B; general-B serving runs the plain loop")
NO_PROX_KERNEL = ValueError(
    f"prox kernel unavailable (m={M}, d={M}): this prox has no kernel variant (group_l2's row norm stays on the "
    "plain loop, ops/prox.py); use kernel='auto'"
)

# (kernel, served type, B, prox_x) -> the route, or the error.
ROUTES = {
    ("auto", "float32", "I", "l1"): "whole-unroll-plain-cpu",
    ("auto", "float32", "I", "nonneg_l1"): "whole-unroll-plain-cpu-prox",
    ("auto", "float32", "I", "group_l2"): "plain-loop-prox",
    ("auto", "float32", "B", "l1"): "plain-loop-general-B",
    ("auto", "float32", "B", "nonneg_l1"): PROX_B,
    ("auto", "float32", "B", "group_l2"): PROX_B,
    ("auto", "bfloat16", "I", "l1"): "whole-unroll-bf16-plain-cpu",
    ("auto", "bfloat16", "I", "nonneg_l1"): "whole-unroll-bf16-plain-cpu-prox",
    ("auto", "bfloat16", "I", "group_l2"): "plain-loop-bf16-prox",
    ("auto", "bfloat16", "B", "l1"): "plain-loop-bf16-general-B",
    ("auto", "bfloat16", "B", "nonneg_l1"): PROX_B,
    ("auto", "bfloat16", "B", "group_l2"): PROX_B,
    ("auto", "int8", "I", "l1"): "int8-unroll-plain-cpu",
    ("auto", "int8", "I", "nonneg_l1"): INT8_PROX,
    ("auto", "int8", "I", "group_l2"): INT8_PROX,
    ("auto", "int8", "B", "l1"): INT8_B,
    ("auto", "int8", "B", "nonneg_l1"): INT8_B,
    ("auto", "int8", "B", "group_l2"): INT8_B,
    ("megakernel", "float32", "I", "l1"): "whole-unroll-plain-cpu",
    ("megakernel", "float32", "I", "nonneg_l1"): "whole-unroll-plain-cpu-prox",
    ("megakernel", "float32", "I", "group_l2"): NO_PROX_KERNEL,
    ("megakernel", "float32", "B", "l1"): B_MEGAKERNEL,
    ("megakernel", "float32", "B", "nonneg_l1"): PROX_B,
    ("megakernel", "float32", "B", "group_l2"): PROX_B,
    ("megakernel", "bfloat16", "I", "l1"): "whole-unroll-bf16-plain-cpu",
    ("megakernel", "bfloat16", "I", "nonneg_l1"): "whole-unroll-bf16-plain-cpu-prox",
    ("megakernel", "bfloat16", "I", "group_l2"): NO_PROX_KERNEL,
    ("megakernel", "bfloat16", "B", "l1"): B_MEGAKERNEL,
    ("megakernel", "bfloat16", "B", "nonneg_l1"): PROX_B,
    ("megakernel", "bfloat16", "B", "group_l2"): PROX_B,
    ("megakernel", "int8", "I", "l1"): "int8-unroll-plain-cpu",
    ("megakernel", "int8", "I", "nonneg_l1"): INT8_PROX,
    ("megakernel", "int8", "I", "group_l2"): INT8_PROX,
    ("megakernel", "int8", "B", "l1"): INT8_B,
    ("megakernel", "int8", "B", "nonneg_l1"): INT8_B,
    ("megakernel", "int8", "B", "group_l2"): INT8_B,
    ("pallas", "float32", "I", "l1"): "whole-unroll-plain-cpu",
    ("pallas", "float32", "I", "nonneg_l1"): "plain-loop-prox",
    ("pallas", "float32", "I", "group_l2"): "plain-loop-prox",
    ("pallas", "float32", "B", "l1"): B_PALLAS,
    ("pallas", "float32", "B", "nonneg_l1"): PROX_B,
    ("pallas", "float32", "B", "group_l2"): PROX_B,
    ("pallas", "bfloat16", "I", "l1"): "whole-unroll-bf16-plain-cpu",
    ("pallas", "bfloat16", "I", "nonneg_l1"): "plain-loop-bf16-prox",
    ("pallas", "bfloat16", "I", "group_l2"): "plain-loop-bf16-prox",
    ("pallas", "bfloat16", "B", "l1"): B_PALLAS,
    ("pallas", "bfloat16", "B", "nonneg_l1"): PROX_B,
    ("pallas", "bfloat16", "B", "group_l2"): PROX_B,
    ("pallas", "int8", "I", "l1"): INT8_PALLAS,
    ("pallas", "int8", "I", "nonneg_l1"): INT8_PROX,
    ("pallas", "int8", "I", "group_l2"): INT8_PROX,
    ("pallas", "int8", "B", "l1"): INT8_B,
    ("pallas", "int8", "B", "nonneg_l1"): INT8_B,
    ("pallas", "int8", "B", "group_l2"): INT8_B,
    ("reference", "float32", "I", "l1"): "plain-loop-reference",
    ("reference", "float32", "I", "nonneg_l1"): "plain-loop-prox",
    ("reference", "float32", "I", "group_l2"): "plain-loop-prox",
    ("reference", "float32", "B", "l1"): "plain-loop-general-B",
    ("reference", "float32", "B", "nonneg_l1"): PROX_B,
    ("reference", "float32", "B", "group_l2"): PROX_B,
    ("reference", "bfloat16", "I", "l1"): "plain-loop-bf16-reference",
    ("reference", "bfloat16", "I", "nonneg_l1"): "plain-loop-bf16-prox",
    ("reference", "bfloat16", "I", "group_l2"): "plain-loop-bf16-prox",
    ("reference", "bfloat16", "B", "l1"): "plain-loop-bf16-general-B",
    ("reference", "bfloat16", "B", "nonneg_l1"): PROX_B,
    ("reference", "bfloat16", "B", "group_l2"): PROX_B,
    ("reference", "int8", "I", "l1"): "plain-loop-int8-reference",
    ("reference", "int8", "I", "nonneg_l1"): INT8_PROX,
    ("reference", "int8", "I", "group_l2"): INT8_PROX,
    ("reference", "int8", "B", "l1"): INT8_B,
    ("reference", "int8", "B", "nonneg_l1"): INT8_B,
    ("reference", "int8", "B", "group_l2"): INT8_B,
}


@pytest.fixture(scope="module")
def net():
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(M, N, generator=gen)
    A /= A.norm(dim=0, keepdim=True)
    return A, torch.randn(M, M, generator=gen), init_dladmm_params(A, K=K)


def _raises(want: ValueError):
    return pytest.raises(ValueError, match="^" + re.escape(str(want)) + "$")


@pytest.mark.parametrize("case", list(ROUTES), ids="-".join)
def test_route_table(net, case):
    kernel, dtype, b_kind, prox = case
    want = ROUTES[case]
    A, B, params = net

    def server():
        return serve.InferenceServer(params, A, buckets=(BUCKET,), kernel=kernel, dtype=dtype,
                                     B=B if b_kind == "B" else None, prox_pair=PAIRS[prox], device="cpu")

    if isinstance(want, ValueError):
        with _raises(want):
            server()
    else:
        assert server().routes == {BUCKET: want}
    if b_kind == "B" or dtype == "int8":
        return
    storage = getattr(torch, dtype)
    solver = DLADMMSolver(A=A.to(storage), params=params.to(storage), kernel=kernel, prox_x=prox)
    if kernel == "pallas" and prox != "l1":
        with pytest.raises(ValueError, match="l1/l1-only"):
            solver._paths(BUCKET)
        return
    if isinstance(want, ValueError):
        with _raises(want):
            solver._paths(BUCKET)
        return
    assert solver._paths(BUCKET)[2] == want
    table = serving.measure(m=M, n=N, K=K, buckets=(BUCKET,), kernel=kernel,
                            dtype=None if dtype == "float32" else storage,
                            prox=None if prox == "l1" else prox, iters=1, device="cpu")
    routes = [row["route"] for row in table["buckets"]]
    if prox == "l1":
        assert routes == [want]
    else:
        assert want in routes
