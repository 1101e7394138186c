"""The cell denoise-train: its entries validate, its traffic kind
(traffic/denoise_steps.py) rehearses on the CPU and reads ``correct``,
the reference's dictionary, images and patch pipeline are the program's
bit for bit,
the faults planted under its timed path fail, a program without the
denoiser's step fails at set-up, and the readers it is listed under read
its hand-made trace at its own shape and batch; on the card, the
controls fail at the cell's size."""

import contextlib
import io
import json
import sys
import types

import pytest
import torch

from benchmark import run as bench
from benchmark import spec as specs
from benchmark.reference import compare
from benchmark.reference import denoise as ref_denoise
from benchmark.tests.test_bench_yardstick import _ev
from benchmark.traffic.denoise_steps import step_seed
from benchmark.yardstick import images as yimg
from benchmark.yardstick import roofline as ys
from benchmark.yardstick.synthetic import step_generator

ROOT = specs.ROOT
CELL, CONFIG, TRAFFIC = "denoise-train", "denoise_dct", "denoise_b4x512"
APPENDED = ("kernels_per_step", "traj_roofline", "bwd_roofline", "idle_pct.train", "data_idle_pct.train",
            "optimizer_ms.train")
NEW = ("patches_ms.denoise",)
S = 4 * 127 ** 2


def _cfg():
    return specs.config(specs.load(), CONFIG)


def _read(name, ctx):
    return specs.load_module(specs.metric_file(ROOT, name), name).read(ctx)


def test_the_cell_its_configuration_and_metrics_validate():
    spec = specs.load()
    specs.validate(spec)
    cell = specs.cell(spec, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, TRAFFIC, 1)
    assert [m["name"] for m in specs.per_layer(spec, CELL)] == list(APPENDED + NEW)
    assert [m["name"] for m in specs.end_to_end(spec, CELL)] == ["train_samples_per_s", "setup_s"]
    cfg = _cfg()
    entry = next(c for c in spec["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == cfg["reduced"] == []
    assert (cfg["m"], cfg["n"], cfg["K"], cfg["beta"]) == (64, 256, 15, 1.0)
    assert (cfg["patch"], cfg["atoms_per_dim"], cfg["stride"], cfg["density"]) == (8, 16, 4, 0.1)
    assert (cfg["images"], cfg["size"], cfg["mode"], cfg["dictionary"]) == (4, 512, "denoise", "dct")
    t = cfg["train"]
    assert (t["lr"], t["lr_schedule"], t["clip_norm"], t["layer_loss"], t["moment_dtype"]) == (
        1e-3, None, None, None, "float32")
    assert cfg["init"] == specs.config(spec, "tp_large")["init"]
    mix = specs.mix(TRAFFIC)
    assert mix["kind"] == "denoise_steps" and mix["start_step"] == 50
    assert set(mix["limits"]) == set(mix["limits_why"]) == {"loss_gap", "grad_gap", "change_gap", "change_diff"}


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_rehearses_on_the_cpu(trace):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--workload", CELL, "--seed", str(2**31 + 13), "--seconds", "0.6", "--trace", str(trace),
                         "--rehearse"])
    line = json.loads([ln for ln in buf.getvalue().splitlines() if ln.startswith("{")][-1])
    assert rc == 0 and line["rehearsal"] and line["correct"] and "metrics" not in line
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("patch,atoms", [(8, 16), (4, 8), (5, 7)])
def test_the_references_dictionary_is_the_programs(patch, atoms):
    """yardstick/images.dct_dictionary, which the reference's loss and
    the seed's parameters are built on, is data/dictionary.dct_dictionary
    bit for bit: the cell's 8 x 8 patches on 16 atoms a dimension, the
    rehearsal's, and an odd pair."""
    from dladmm_tpu_torch.data.dictionary import dct_dictionary

    ref = yimg.dct_dictionary(patch, atoms)
    assert ref.dtype == torch.float32 and ref.shape == (patch ** 2, atoms ** 2)
    assert torch.equal(ref, dct_dictionary(patch, atoms))


@pytest.mark.parametrize("size", [16, 64, 100, 512])
def test_the_references_clean_image_is_the_programs(size):
    """yardstick/images.synthetic_image, the reference's clean images, is
    data/images.synthetic_image bit for bit, at the cell's 512 and at
    the tests' sizes."""
    from dladmm_tpu_torch.data.images import synthetic_image

    ref = yimg.synthetic_image(size)
    assert ref.dtype == torch.float32 and ref.shape == (size, size)
    assert torch.equal(ref, synthetic_image(size))


def test_the_references_patch_pipeline_is_the_programs():
    """From one generator each: the corruption (two uniform draws an
    image, the images in order), the windows, the median DC and the three
    row blocks equal the program's _make_patch_batch bit for bit, at the
    cell's 8 x 8 windows and stride 4 on two 64 x 64 images."""
    from dladmm_tpu_torch.data import images
    from dladmm_tpu_torch.run_denoise import _make_patch_batch

    clean = [images.synthetic_image(64), images.synthetic_image(64)]
    seed = step_seed(2**31 + 29, 51)
    assert seed == step_generator(2**31 + 29, 51).initial_seed()
    prog = _make_patch_batch(torch.Generator().manual_seed(seed), clean, 0.1, 8, 4)
    gen = torch.Generator().manual_seed(seed)
    noisy = [yimg.salt_pepper(gen, img, 0.1) for img in clean]
    ref = ref_denoise.patch_batch(noisy, clean, 8, 4)
    assert ref[0].shape == (2 * 15 ** 2, 64)
    for a, b in zip(prog, ref):
        assert torch.equal(a, b)
    rows = ref_denoise.patches(noisy[0], 8, 4)
    assert torch.equal(rows, images.extract_patches(noisy[0], 8, 4))
    assert torch.equal(ref_denoise.median_dc(rows), images.patch_dc(rows))


def _rehearsed(fault=None, seed=2**31 + 31):
    work = bench.workload(_cfg(), specs.mix(TRAFFIC), seed, 0.4, torch.device("cpu"), rehearse=True)
    work.fault = fault
    work.setup()
    run = work.measure()
    work.release()
    return work, run


def test_a_sound_run_is_correct_and_counts_the_patches():
    work, run = _rehearsed()
    assert run["failed"] == 0 and compare.passed(work.check())
    assert work.recipe["batch"] == 2 * 4 ** 2  # two 16 x 16 images, 4 x 4 windows at stride 4
    assert run["metrics"]["train_samples_per_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "flipped"])
def test_a_fault_under_the_timed_path_makes_correct_false(fault):
    work, _ = _rehearsed(fault)
    assert not compare.passed(work.check())


def test_the_half_batch_control_fails():
    work, _ = _rehearsed()
    assert not compare.passed(work.check(control="half_batch"))


def test_a_program_without_the_denoisers_step_fails_at_set_up(monkeypatch):
    """A program that has no make_denoise_step (the port before this
    cell) fails set-up at once, before it builds or draws anything."""
    monkeypatch.setitem(sys.modules, "dladmm_tpu_torch.run_denoise", types.ModuleType("dladmm_tpu_torch.run_denoise"))
    work = bench.workload(_cfg(), specs.mix(TRAFFIC), 3, 0.4, torch.device("cpu"), rehearse=True)
    with pytest.raises(ImportError):
        work.setup()
    assert not hasattr(work, "A")


def _step_trace():
    """A window [0, 1000] us: two bench.step spans, each holding a
    train.data span (its two kernels 5 and 7 us) and a
    train.optimizer span (two elementwise kernels, 20 and 30 us); a
    trajectory launch (300) and a reverse sweep (chain 100, weights 50,
    finish 10)."""
    ev = [_ev("user_annotation", "bench.window", 0, 1000),
          _ev("user_annotation", "bench.step", 0, 480), _ev("user_annotation", "bench.step", 490, 500),
          _ev("user_annotation", "train.step", 0, 480), _ev("user_annotation", "train.step", 490, 500),
          _ev("user_annotation", "train.data", 0, 40), _ev("user_annotation", "train.data", 490, 10),
          _ev("user_annotation", "train.optimizer", 400, 70), _ev("user_annotation", "train.optimizer", 900, 80),
          *(_ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=c)
            for ts, c in ((1, 5), (3, 6), (491, 7), (493, 8), (401, 1), (410, 2), (901, 3), (910, 4))),
          _ev("kernel", "void (anonymous namespace)::traj_persistent<32, float>(TrajArgs<float>)", 50, 300, tid=7),
          _ev("kernel", "void (anonymous namespace)::bwd_chain<32, float>(ChainArgs<float>)", 500, 100, tid=7),
          _ev("kernel", "void (anonymous namespace)::bwd_weights<float>(WeightArgs<float>)", 600, 50, tid=7),
          _ev("kernel", "void (anonymous namespace)::finish<float>(float const*)", 650, 10, tid=7),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, UniformFunctor)", 10, 5, tid=7, corr=5),
          _ev("kernel", "void at::native::bitonicSortKVInPlace<float>(float*)", 20, 7, tid=7, corr=6),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, UniformFunctor)", 495, 5, tid=7, corr=7),
          _ev("kernel", "void at::native::bitonicSortKVInPlace<float>(float*)", 700, 7, tid=7, corr=8),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, MulFunctor)", 420, 20, tid=7, corr=1),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, AddFunctor)", 440, 30, tid=7, corr=2),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, MulFunctor)", 920, 20, tid=7, corr=3),
          _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int, AddFunctor)", 940, 30, tid=7, corr=4),
          _ev("kernel", "at::cuda::spin_kernel(long)", 0, 10, tid=7)]
    return {"events": ev, "lo": 0.0, "hi": 1000.0, "cfg": _cfg(), "mix": specs.mix(TRAFFIC), "batch": S}


def test_the_readers_read_the_cell_at_its_shape_and_batch():
    """The new reader, the mean device time a train.data span
    ((5 + 7 + 5 + 7) / 2 us); and the accepted readers the cell was
    appended to, at m = 64, n = 256, K = 15 and S = 64 516 patches: one
    trajectory launch and one reverse sweep (its one chain launch) against
    their bounds, the optimizer's kernels a span, the kernels a step, the
    idle share, and the idle time inside train.data (0-10 under the
    marker, which counts as idle, 15-20, 27-40 and 490-495)."""
    ctx = _step_trace()
    assert _read("patches_ms.denoise", ctx) == pytest.approx(0.012)
    assert _read("traj_roofline", ctx) == pytest.approx(100 * ys.traj_bound(S, 64, 256, 15, True)[0] * 1e3 / 300)
    assert _read("bwd_roofline", ctx) == pytest.approx(100 * ys.bwd_bound(S, 64, 256, 15)[0] * 1e3 / 160)
    assert _read("optimizer_ms.train", ctx) == pytest.approx(0.05)
    assert _read("kernels_per_step", ctx) == 12 / 2  # the marker left out
    busy = 300 + 160 + 2 * 50 + 5 + 7 + 5 + 7
    assert _read("idle_pct.train", ctx) == pytest.approx(100 * (1 - busy / 1000))
    assert _read("data_idle_pct.train", ctx) == pytest.approx(100 * (10 + 5 + 13 + 5) / 1000)
    bare = {**ctx, "events": [e for e in ctx["events"] if e["cat"] != "kernel"]}
    assert all(_read(name, bare) is None for name in APPENDED + NEW)


def test_train_mfu_is_not_the_cells():
    """train_step_flops counts the unroll's forward and reverse sweep but
    not the reconstruction product x_K A^T and its gradient, so the cell
    is not listed under train_mfu."""
    spec = specs.load()
    assert CELL not in next(m for m in spec["per_layer"] if m["name"] == "train_mfu")["workloads"]
    assert ys.train_step_flops(S, 64, 256, 15) == ys.solve_flops(S, 64, 256, 15) + ys.bwd_flops(S, 64, 256, 15)


@pytest.mark.gpu
def test_the_controls_fail_on_the_card_at_the_cell_s_size():
    """On three seeds the reference in TF32 put in the program's place and
    the reference on half the patches each fail the check; on one seed
    the faults "unchanged", "flipped" and "half_batch" planted in the
    program fail it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cell's size exist only there")
    from benchmark import harness

    harness.host_threads()
    dev = torch.device("cuda", 0)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        work = bench.workload(_cfg(), specs.mix(TRAFFIC), seed, 1.0, dev)
        work.setup()
        work.release()
        assert compare.passed(work.check()), seed
        for control in ("tf32", "half_batch"):
            assert not compare.passed(work.check(control=control)), (seed, control)
        del work
        torch.cuda.empty_cache()
    for fault in ("unchanged", "flipped", "half_batch"):
        work = bench.workload(_cfg(), specs.mix(TRAFFIC), 2**31 + 404, 1.0, dev)
        work.fault = fault
        work.setup()
        work.release()
        assert not compare.passed(work.check()), fault
        del work
        torch.cuda.empty_cache()
