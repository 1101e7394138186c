"""The port's benchmarking tools on the CPU: comm_model's analytic fields
against the JAX package's for every sharded preset and layout (its rates
the same arithmetic at the published H100 figures), roofline's work
counts against the JAX package's and the kernels' bounds at the values
PERF.md's table quotes, time_chained's two-point slope and its fallback,
serving --smoke, scaling on 1 and 2 gloo ranks (and a 1x2 TP mesh), the
rank spawner's deadline and failures, and data/synthetic.batch_stream.
The card's side (row 1 chained, the serving kernels counted) is
tests/test_torch_cuda.py (``gpu``) and chip_smoke.py phases 44-48."""

import contextlib
import io
import json
import math
import sys
import warnings

import numpy as np
import pytest
import torch

from dladmm_tpu.bench import comm_model as jcomm
from dladmm_tpu_torch.bench import comm_model, roofline, serving, timing
from dladmm_tpu_torch.utils.config import PRESETS

SMALL = dict(m=250, n=500, K=15)
LARGE = dict(m=1000, n=2000, K=20)
SHARDED = sorted(n for n, c in PRESETS.items() if c.sharding.data_axis * c.sharding.model_axis > 1
                 or c.sharding.multihost)
LAYOUTS = ("sharded_w2", "replicated_w2")
# The renamed keys, JAX name -> port name (TPU links -> NVLink and hosts).
RENAMED = {"ici_mb_per_step": "nvlink_mb_per_step", "dp_crosses_dcn": "dp_crosses_hosts"}
ANALYTIC = ("config", "layout", "mesh", "hosts", "per_chip_gb", "per_chip_tflops_per_step", "dp_allreduce_mb",
            "zero1_optimizer_hbm_mb_per_step", "zero1_optimizer_hbm_mb_replicated", "zero1_moments_gb_per_chip",
            "zero1_int8_fused_moments_gb_per_chip")


def _args(name, layout):
    cfg = PRESETS[name]
    p, t, s = cfg.problem, cfg.train, cfg.sharding
    return (name, p.m, p.n, p.K, t.batch, s.data_axis, s.model_axis, layout, 2 if s.multihost else 1), dict(
        compute_dtype_bytes=2 if t.compute_dtype == "bfloat16" else None)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", SHARDED)
def test_comm_model_matches_jax(name, layout):
    """The analytic fields equal the JAX package's, the renamed keys one to
    one; the step-time fields are the same arithmetic at the H100 rates,
    the compute at the peak of the preset's compute dtype (bf16 989, fp32
    67 TFLOP/s);
    fits_card holds the bytes against 90% of 80 GB (72 GB), and against
    16 GB it is the JAX package's fits_16gb_chip."""
    args, kw = _args(name, layout)
    j = jcomm.analyze(*args, **kw)
    t = comm_model.analyze(*args, **kw)
    for key in ANALYTIC:
        assert (key in t) == (key in j), key
        if key in j:
            assert t[key] == j[key], key
    for jkey, tkey in RENAMED.items():
        assert t[tkey] == j[jkey] and jkey not in t
    assert set(t["model_step_ms"]) == {"compute", "tp_nvlink", "dp_allreduce"}
    assert "fits_16gb_chip" not in t

    from dladmm_tpu_torch.parallel.memory import per_chip_bytes, step_traffic_bytes

    m, n, K, S, D, T, hosts = args[1], args[2], args[3], args[4], args[5], args[6], args[8]
    cb = kw["compute_dtype_bytes"]
    total = per_chip_bytes(m, n, K, S, D, T, layout, 4, cb).total
    tr = step_traffic_bytes(m, n, K, S, D, T, layout, cb or 4, hosts)
    fl = comm_model.flops_per_chip_per_step(m, n, K, max(1, S // D), T, layout)
    assert fl == jcomm.flops_per_chip_per_step(m, n, K, max(1, S // D), T, layout)
    assert t["model_step_ms"]["compute"] == round(fl / (989e12 if cb == 2 else 67e12) * 1e3, 3)
    assert t["model_step_ms"]["tp_nvlink"] == round(tr["tp_ici_bytes_per_step"] / 900e9 * 1e3, 3)
    assert t["model_step_ms"]["dp_allreduce"] == round(
        tr["dp_grad_allreduce_bytes"] / ((50e9 if hosts > 1 else 900e9)) * 1e3, 3)
    assert t["fits_card"] == (total <= 72e9)
    assert comm_model.analyze(*args, **kw, hbm_gb=16)["fits_card"] == j["fits_16gb_chip"]


def test_comm_model_cli(tmp_path):
    """tp_large at 16 GB: sharded_w2 fits and replicated_w2 does not (the
    JAX package's test_comm_model_cli); at the card's 80 GB both fit."""
    out = tmp_path / "cm.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert comm_model.main(["--config", "tp_large", "--hbm-gb", "16", "--out", str(out)]) == 0
    layouts = {r["layout"]: r for r in json.loads(out.read_text())}
    assert layouts["sharded_w2"]["fits_card"] and not layouts["replicated_w2"]["fits_card"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        comm_model.main(["--config", "tp_large"])
    assert all(r["fits_card"] for r in json.loads(buf.getvalue()))


def test_comm_model_fused_dp_fields():
    """DP-only rows carry the fused optimizer's overlap bracket: one
    layer's all-reduce exposed when a layer's backward covers it, more
    when it does not; the efficiency within (no_overlap, 1]; TP rows carry
    none (tests/test_aux.py's case)."""
    f = comm_model._fused_dp_fields(K=10, t_compute=0.030, t_nvlink=0.0, t_dp=0.010)
    assert f["dp_fused_exposed_ms_if_pipelined"] == 1.0
    g = comm_model._fused_dp_fields(K=10, t_compute=0.003, t_nvlink=0.0, t_dp=0.010)
    assert g["dp_fused_exposed_ms_if_pipelined"] > 1.0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        comm_model.main(["--config", "multihost"])
    rows = json.loads(buf.getvalue())
    assert rows and all("scaling_efficiency_fused_if_pipelined" in r for r in rows)
    for r in rows:
        assert r["scaling_efficiency_no_overlap"] < r["scaling_efficiency_fused_if_pipelined"] <= 1.0
        assert r["dp_crosses_hosts"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        comm_model.main(["--config", "tp_large"])
    assert all("scaling_efficiency_fused_if_pipelined" not in r for r in json.loads(buf.getvalue()))


def test_comm_model_zero1_fields():
    """ZeRO-1's model fields: the optimizer's streams and moments shrink by
    exactly D, the collective bytes stay; TP rows carry none."""
    r = comm_model.analyze("z", 1000, 2000, 20, 1024, 8, 1, "sharded_w2", hosts=2)
    assert r["zero1_optimizer_hbm_mb_per_step"] == pytest.approx(r["zero1_optimizer_hbm_mb_replicated"] / 8,
                                                                 rel=0.01)
    assert "allreduce = RS+AG" in r["zero1_note"]
    assert "zero1_note" not in comm_model.analyze("t", 1000, 2000, 20, 1024, 2, 4, "sharded_w2")


def test_comm_model_names_no_tpu_figure():
    """No TPU rate or chip size is left in the module's constants or keys."""
    names = [k for k in vars(comm_model) if k.isupper()]
    assert not [k for k in names if "ICI" in k or "DCN" in k]
    row = comm_model.analyze("t", 256, 512, 8, 128, 2, 2, "sharded_w2")
    keys = list(row) + list(row["model_step_ms"])
    assert not [k for k in keys if k.startswith("ici") or "_ici" in k or "dcn" in k or "16gb" in k]
    assert (comm_model.NVLINK_GBPS, comm_model.CARD_HBM_GB) == (900.0, 80.0)
    assert (comm_model.PEAK_FP32_FLOPS, comm_model.PEAK_BF16_FLOPS) == (roofline.PEAK_FP32_FLOPS,
                                                                      roofline.PEAK_BF16_FLOPS)


def test_roofline_work_counts_match_jax():
    """flops_g and ideal_min_hbm_mb equal the JAX package's analyze at a
    small shape on the CPU; both paths run there (the kernel's plain
    version), each fraction finite and positive."""
    from dladmm_tpu.bench import roofline as jroof

    shape = dict(m=24, n=48, K=3, S=8)
    j = jroof.analyze(**shape, paths=("reference",), iters=4)
    t = roofline.analyze(**shape, iters=4, device="cpu")
    assert (t["flops_g"], t["ideal_min_hbm_mb"]) == (j["flops_g"], j["ideal_min_hbm_mb"])
    big = dict(m=250, n=500, K=15, S=1024)
    flops = 2 * big["S"] * big["m"] * (2 * big["n"] + big["m"]) * big["K"]
    assert round(flops / 1e9, 2) == 9.6
    assert [r["path"] for r in t["paths"]] == ["reference", "megakernel"]
    for r in t["paths"]:
        for key in ("time_us", "frac_of_fp32_peak", "frac_of_memory_bound", "frac_of_roofline"):
            assert math.isfinite(r[key]) and r[key] > 0
        assert "frac_of_mxu_peak_bf16" not in r
    assert t["paths"][1]["route"] == "whole-unroll-plain-cpu" and t["paths"][1]["launches"] == 0
    assert t["device"] == "cpu" and "perf_counter" in t["time_from"]


@pytest.mark.parametrize("fn,args,want,by", [
    (roofline.bound, (256,), 0.0358, "operations"),
    (roofline.bound, (64,), 0.00896, "operations"),
    (roofline.bwd_bound, (64,), 0.01433, "operations"),
    (roofline.int8_serve_bound, (256,), 0.001286, "bytes"),
])
def test_kernel_bounds_at_synthetic_small(fn, args, want, by):
    """The bounds moved from chip_smoke.py give PERF.md's table's values."""
    ms, got_by = fn(*args, **SMALL)
    assert ms == pytest.approx(want, rel=1e-3) and got_by == by


def test_kernel_bounds_other_shapes():
    assert roofline.bound(1024, **LARGE)[0] == pytest.approx(3.057, rel=1e-3)
    assert roofline.bwd_bound(64, **SMALL, itemsize=2) == (pytest.approx(0.005373, rel=1e-3), "operations")
    assert roofline.layer_bound(256, 250, 500)[0] == pytest.approx(0.002388, rel=1e-3)
    shapes = roofline.STEP_SHAPES["synthetic_small"]
    assert roofline.step_bounds(shapes, "float32")["step"] == (pytest.approx(0.02360, rel=1e-3), "bytes")
    assert roofline.step_bounds(shapes, "int8")["step"] == (pytest.approx(0.01354, rel=1e-3), "bytes")
    assert (roofline.PEAK_FP32_FLOPS, roofline.PEAK_BF16_FLOPS, roofline.PEAK_INT8_OPS,
            roofline.PEAK_BYTES_PER_S) == (67e12, 989e12, 1979e12, 3.35e12)


def test_time_chained_noise_fallback(monkeypatch):
    """A non-positive slope after four chain doublings falls back to the
    uncalibrated long-chain estimate with a warning (0.5 s over the last
    chain's 64 steps), and strict=True raises (tests/test_aux.py's case)."""
    monkeypatch.setattr(timing, "_run_chained", lambda step, init, iters, repeats: 0.5)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t = timing.time_chained(lambda c: c, 0.0, iters=8)
    assert any("UNCALIBRATED" in str(x.message) for x in w)
    assert t == pytest.approx(0.5 / 64)
    with pytest.raises(RuntimeError, match="no positive slope"):
        timing.time_chained(lambda c: c, 0.0, iters=8, strict=True)


def test_time_chained_slope_and_agree(monkeypatch):
    """The slope of the two chain lengths cancels a fixed cost exactly;
    ``agree`` sees every chain's time before it is used; a real CPU
    chain gives a positive time."""
    monkeypatch.setattr(timing, "_run_chained", lambda step, init, iters, repeats: 0.3 + 0.01 * iters)
    assert timing.time_chained(lambda c: c, 0.0, iters=16) == pytest.approx(0.01)
    seen = []
    got = timing.time_chained(lambda c: c, 0.0, iters=16, agree=lambda s: seen.append(s) or 2 * s)
    assert got == pytest.approx(0.02) and seen == [pytest.approx(0.34), pytest.approx(0.46)]
    monkeypatch.undo()
    M = torch.randn(64, 64) / 8
    assert timing.time_chained(lambda c: torch.tanh(c @ M), torch.randn(64, 64), iters=16) > 0


def test_serving_smoke_on_the_cpu():
    """serving --smoke --dtype=all --prox=nonneg_l1 on the CPU: every dtype
    and the prox table, both int8 paths and both prox paths at every
    bucket, routes the plain versions', throughput = bucket / latency."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert serving.main(["--smoke", "--dtype=all", "--prox=nonneg_l1", "--iters=4"]) == 0
    tables = json.loads(out.getvalue())
    assert [(t["dtype"], t.get("prox_x")) for t in tables] == [
        ("float32", None), ("bfloat16", None), ("int8", None), ("float32", "nonneg_l1")]
    routes = {t["dtype"] + str(t.get("prox_x")): sorted({r["route"] for r in t["buckets"]}) for t in tables}
    assert routes == {
        "float32None": ["whole-unroll-plain-cpu"], "bfloat16None": ["whole-unroll-bf16-plain-cpu"],
        "int8None": ["int8-unroll-plain-cpu", "plain-loop-int8-reference"],
        "float32nonneg_l1": ["plain-loop-prox", "whole-unroll-plain-cpu-prox"]}
    for t in tables:
        assert t["device"] == "cpu" and "SMOKE_MODE" in t and t["dispatch_overhead_ms"] > 0
        assert "perf_counter" in t["latency_from"]
        per = 2 if t["dtype"] == "int8" or t.get("prox_x") else 1
        assert [r["bucket"] for r in t["buckets"]] == [b for b in (1, 8, 64) for _ in range(per)]
        for r in t["buckets"]:
            lat = r["latency_us"] * 1e-6
            assert lat > 0 and r["throughput_solves_per_s"] == pytest.approx(r["bucket"] / lat)
            assert r["launches"] is None  # plain versions: no kernel ran


def test_serving_refusals(monkeypatch):
    """elastic_net at rho = 0 is l1 and is refused; a general prox refuses
    int8; without CUDA a bench asked for the card raises."""
    with pytest.raises(ValueError, match="reduces to l1"):
        serving.measure(m=8, n=16, K=2, buckets=(1,), prox="elastic_net", prox_rho=0.0, device="cpu")
    with pytest.raises(ValueError, match="rejects int8"):
        serving.measure(m=8, n=16, K=2, buckets=(1,), dtype="int8", prox="nonneg_l1", device="cpu")
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("DLADMM_PLATFORM", raising=False)
    for run in (lambda: serving.measure(m=8, n=16, K=2, buckets=(1,)),
                lambda: roofline.analyze(8, 16, 2, 4, iters=4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()


def test_scaling_virtual_on_one_and_two_ranks():
    """measure_dp_scaling with virtual ranks (gloo on the CPU) at a tiny
    shape: 1 and 2 DP ranks and a 1x2 TP mesh, each spawn within 120 s;
    the measured fields under harness_validation_only, the analytic
    bracket top-level."""
    from dladmm_tpu_torch.bench.scaling import measure_dp_scaling

    rows = measure_dp_scaling([(1, 1), (2, 1), (1, 2)], m=16, n=32, K=3, per_device_batch=8, iters=4,
                              virtual=True, timeout=120)
    assert [(r["mesh"], r["devices"], r["global_batch"]) for r in rows] == [("1x1", 1, 8), ("2x1", 2, 16),
                                                                            ("1x2", 2, 8)]
    for r in rows:
        assert r["backend"] == "gloo" and r["device_kind"] == "cpu" and r["launches_rank0"] == {}
        assert "step_ms" not in r and "CPU" in r["harness_validation_only"]["note"]
        h = r["harness_validation_only"]
        assert h["step_ms"] > 0 and h["layer_iter_per_s"] == pytest.approx(3 * r["global_batch"] / h["step_ms"] * 1e3)
        assert all(0 < e <= 1 for e in r["model_efficiency_bracket"])
    assert rows[0]["harness_validation_only"]["efficiency_vs_linear"] == 1.0


def test_spawn_ranks_deadline_and_failures(tmp_path):
    """The spawner gives each rank the env:// variables and its store's
    port, kills the ranks at its deadline (TimeoutError) and raises on a
    rank's non-zero exit with the ranks' output."""
    from dladmm_tpu_torch.parallel.multihost import spawn_ranks

    code = ("import os; print(os.environ['RANK'], os.environ['WORLD_SIZE'], os.environ['MASTER_PORT'], "
            "os.environ['TORCHELASTIC_USE_AGENT_STORE'])")
    logs = spawn_ranks([sys.executable, "-c", code], 2, timeout=60)
    ports = {ln.split()[2] for ln in logs}
    assert [ln.split()[:2] for ln in logs] == [["0", "2"], ["1", "2"]] and len(ports) == 1
    with pytest.raises(TimeoutError, match="did not end within"):
        spawn_ranks([sys.executable, "-c", "import time; time.sleep(60)"], 2, timeout=2)
    with pytest.raises(RuntimeError, match=r"exit codes \[0, 3\]"):
        spawn_ranks([sys.executable, "-c", "import os, sys; sys.exit(3 * int(os.environ['RANK']))"], 2,
                    timeout=60)


def test_batch_stream():
    """batch_stream is deterministic for its generator's seed, its batches
    differ from one to the next, and each is b = x* A^T + e*."""
    from dladmm_tpu_torch.data.synthetic import batch_stream, make_dictionary

    A = make_dictionary(torch.Generator().manual_seed(3), 12, 24)
    s1 = batch_stream(torch.Generator().manual_seed(5), A, 6)
    s2 = batch_stream(torch.Generator().manual_seed(5), A, 6)
    first = [next(s1) for _ in range(3)]
    again = [next(s2) for _ in range(3)]
    for a, b in zip(first, again):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(first[0].b, first[1].b) and not torch.equal(first[1].x_star, first[2].x_star)
    for bt in first:
        assert bt.b.shape == (6, 12) and bt.x_star.shape == (6, 24) and bt.e_star.shape == (6, 12)
        np.testing.assert_allclose(bt.b.numpy(), (bt.x_star @ A.T + bt.e_star).numpy(), rtol=0, atol=0)
