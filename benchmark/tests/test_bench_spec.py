"""BENCHMARK.json and the files it names: the contract's rules, and that
a new configuration, traffic kind, metric and cell are added as files."""

import json
import shutil

import pytest

from benchmark import run as bench
from benchmark import spec as specs

ROOT = specs.ROOT


def test_benchmark_json_is_valid_and_every_file_parses():
    spec = specs.load()
    specs.validate(spec)
    for c in spec["workloads"]:
        cfg = specs.config(spec, c["config"])
        mix = specs.mix(c["traffic"])
        assert {"m", "n", "K", "train", "init", "source", "reduced", "assumed"} <= set(cfg)
        assert mix["kind"] and mix["limits"]
    for m in spec["per_layer"]:
        assert callable(specs.load_module(specs.metric_file(ROOT, m["name"]), m["name"]).read)


def test_names_and_units_use_the_allowed_characters():
    spec = specs.load()
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["workloads"] + spec["configs"]] + [c["traffic"] for c in spec["workloads"]]
    for name in names:
        assert specs.NAME.fullmatch(name), name
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert specs.UNIT.fullmatch(m["unit"]), m["unit"]
    assert all(c["chips"] == 1 for c in spec["workloads"])


@pytest.mark.parametrize("bad", ["has space", "a,b", "x/y", ".dot", "é", "a" * 65])
def test_a_bad_name_is_refused(bad):
    spec = specs.load()
    spec["workloads"][0]["name"] = bad
    with pytest.raises(specs.SpecError):
        specs.validate(spec)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "a" * 17, ""])
def test_a_bad_unit_is_refused(unit):
    spec = specs.load()
    spec["end_to_end"][0]["unit"] = unit
    with pytest.raises(specs.SpecError):
        specs.validate(spec)


@pytest.mark.parametrize("change", [
    lambda s: s["end_to_end"][0].update(bound=0.3),
    lambda s: s["end_to_end"][0].update(why="a metric takes no why"),
    lambda s: s["per_layer"][0].update(moves="no_such_metric"),
    lambda s: s["workloads"].append(dict(s["workloads"][0], name="twin")),
    lambda s: s["workloads"][0].update(chips=2),
    lambda s: s.update(run_seconds=52),
    lambda s: s["end_to_end"].pop(next(i for i, m in enumerate(s["end_to_end"]) if m["name"] == "setup_s")),
])
def test_a_contract_breach_is_refused(change):
    spec = specs.load()
    change(spec)
    with pytest.raises(specs.SpecError):
        specs.validate(spec)


def test_a_new_config_kind_metric_and_cell_are_files_alone(tmp_path):
    """Into a copy of the benchmark: a configuration, a traffic kind (a
    driver that subclasses an existing one), its mix, a per-layer metric
    and a cell, each a new file or a new entry; nothing else edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    cfg = json.loads((ROOT / "benchmark/configs/synthetic_small.json").read_text())
    (b / "configs/tiny_new.json").write_text(json.dumps({**cfg, "name": "tiny_new", "m": 20, "n": 40, "K": 3}))
    (b / "traffic/closed_twice.py").write_text(
        "from benchmark.traffic.closed_batch import REHEARSAL, Workload  # noqa: F401\n")
    (b / "traffic/batch_small_new.json").write_text(json.dumps({
        "kind": "closed_twice", "rows": 8, "max_batch": 8, "pool_rows": 64, "check_requests": 2,
        "check_among": 4, "warm_requests": 1, "trace_at_s": 0.1, "trace_s": 0.1,
        "limits": {"failed": 0, "x_gap": 2e-5, "z_gap": 6e-5}}))
    (b / "metrics/rows_per_call.new.py").write_text(
        "from benchmark.metrics import solve_calls\n\n\ndef read(ctx):\n"
        "    calls = solve_calls(ctx)\n    return sum(r for r, _, _ in calls) / len(calls) if calls else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_new", "source": "a test configuration", "file": "benchmark/configs/tiny_new.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-new-batch", "config": "tiny_new", "traffic": "batch_small_new",
                              "chips": 1, "why": "a test cell"})
    e2e = next(m for m in spec["end_to_end"] if m["name"] == "serve_rows_per_s")
    e2e["workloads"].append("tiny-new-batch")
    spec["per_layer"].append({"name": "rows_per_call.new", "unit": "rows", "better": "higher",
                              "source": "program_span", "layer": "server, serve.InferenceServer",
                              "moves": "serve_rows_per_s", "workloads": ["tiny-new-batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    specs.validate(json.loads((tmp_path / "BENCHMARK.json").read_text()), tmp_path)
    assert [m["name"] for m in specs.per_layer(spec, "tiny-new-batch")] == ["rows_per_call.new"]
    _, cell, work = bench.build("tiny-new-batch", 3, 0.2, None, root=tmp_path)
    assert cell["traffic"] == "batch_small_new" and work.cfg["m"] == 20
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
