"""Runs of the harness: without a card it fails and prints no result; a
checkout of the benchmark alone fails; every driver rehearses its path
on the CPU at a tiny size (no metric); a fault planted under the timed
path makes ``correct`` false; and, on the card, the control (the
reference in TF32 in the program's place) fails each cell's check."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run as bench
from benchmark import spec as specs
from benchmark.reference import compare

ROOT = specs.ROOT
SPEC = specs.load()
CELLS = [c["name"] for c in SPEC["workloads"]]
# Every driver with a configuration it runs: the cells', and the mixes
# kept for cells not in BENCHMARK.json yet (PERF.md, Open questions).
PAIRS = sorted({(c["config"], c["traffic"]) for c in SPEC["workloads"]}
               | {("synthetic_small", "open_lognormal4"), ("synthetic_small", "train_recipe_b64")})
FAULTS = {"open_loop": ["altered"], "closed_batch": ["altered"], "train_steps": ["unchanged", "half_batch", "flipped"]}


def _cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _last_json(text):
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def _run(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(["--workload", CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"], env=env)
    assert out.returncode != 0
    assert _last_json(out.stdout) is None
    assert "CUDA card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(["--workload", CELLS[0], "--seed", "3", "--seconds", "0.2", "--rehearse"], cwd=tmp_path, env=env)
    assert out.returncode != 0 and _last_json(out.stdout) is None


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_rehearses_on_the_cpu(cell, trace):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--workload", cell, "--seed", str(2**31 + 11), "--seconds", "0.6", "--trace", str(trace),
                         "--rehearse"])
    line = _last_json(buf.getvalue())
    assert rc == 0 and line["rehearsal"] and line["correct"] and "metrics" not in line
    assert line["attempted"] > 0 and line["failed"] == 0


def _rehearsed(config, traffic, fault=None, seed=2**31 + 23):
    work = bench.workload(_cfg(config), specs.mix(traffic), seed, 0.4, torch.device("cpu"), rehearse=True)
    work.fault = fault
    work.setup()
    run = work.measure()
    work.release()
    return run, work.check()


@pytest.mark.parametrize("config,traffic", PAIRS)
def test_every_driver_is_correct_on_a_sound_run(config, traffic):
    run, nums = _rehearsed(config, traffic)
    assert run["failed"] == 0 and compare.passed(nums), nums


@pytest.mark.parametrize("config,traffic,fault", [
    (c, t, f) for c, t in PAIRS for f in FAULTS[specs.mix(t)["kind"]]])
def test_a_fault_under_the_timed_path_makes_correct_false(config, traffic, fault):
    run, nums = _rehearsed(config, traffic, fault)
    assert not compare.passed(nums), nums


@pytest.mark.gpu
@pytest.mark.parametrize("config,traffic", PAIRS)
def test_the_control_fails_on_the_card(config, traffic):
    """At the cell's own size, on three seeds: the reference in TF32 put
    in the program's place fails the check (training also the fault
    "half of the batch left out", planted in the reference)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from benchmark import harness

    harness.host_threads()
    controls = ["tf32", "half_batch"] if specs.mix(traffic)["kind"] == "train_steps" else ["tf32"]
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        work = bench.workload(_cfg(config), specs.mix(traffic), seed, 1.0, torch.device("cuda", 0))
        work.setup()
        work.release()
        for control in controls:
            assert not compare.passed(work.check(control=control)), (traffic, seed, control)
        del work
        torch.cuda.empty_cache()
