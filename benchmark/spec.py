"""``BENCHMARK.json`` and the files it names, loaded and checked.

A cell (an entry of ``workloads``) names a configuration, found in
``configs`` (its ``file``), and a traffic mix, ``traffic/<traffic>.json``,
whose ``kind`` names the driver module ``traffic/<kind>.py``. A per-layer
metric's reader is ``metrics/<name>.py``. ``validate`` checks the whole
file against the benchmark's contract and that every name it uses has
its file, so a new configuration, mix, kind, metric or cell is added as
files alone.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class SpecError(ValueError):
    pass


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _line(text, what, limit=200):
    if not isinstance(text, str) or not 1 <= len(text) <= limit or "\n" in text or "\t" in text:
        raise SpecError(f"{what}: one line of 1 to {limit} characters, no tab")


def _name(text, what):
    if not isinstance(text, str) or not NAME.fullmatch(text):
        raise SpecError(f"{what} {text!r}: at most 64 of letters, digits, _ . - (first not . or -)")


def _keys(entry, required, what, optional=()):
    keys = set(entry)
    if not required <= keys or keys - required - set(optional):
        raise SpecError(f"{what}: keys {sorted(keys)}, expected {sorted(required)} (+{sorted(optional)})")


def traffic_file(root: Path, traffic: str) -> Path:
    return Path(root) / "benchmark" / "traffic" / f"{traffic}.json"


def kind_file(root: Path, kind: str) -> Path:
    return Path(root) / "benchmark" / "traffic" / f"{kind}.py"


def metric_file(root: Path, metric: str) -> Path:
    return Path(root) / "benchmark" / "metrics" / f"{metric}.py"


def cell(spec: dict, name: str) -> dict:
    for c in spec["workloads"]:
        if c["name"] == name:
            return c
    raise SpecError(f"no cell {name!r}; the cells are {[c['name'] for c in spec['workloads']]}")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise SpecError(f"no configuration {name!r}")


def mix(name: str, root: Path = ROOT) -> dict:
    return json.loads(traffic_file(root, name).read_text())


def end_to_end(spec: dict, cell_name: str) -> list:
    return [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(spec: dict, cell_name: str) -> list:
    """The per-layer metrics a cell reports: those listing it, and those
    without ``workloads`` that move an end-to-end metric the cell reports."""
    moved = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (metric files carry
    dots in their names)."""
    mod_name = "benchmark._loaded." + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def validate(spec: dict, root: Path = ROOT) -> None:
    """Raise SpecError where ``spec`` breaks the contract or names a file
    that is missing."""
    root = Path(root)
    if set(spec) != TOP_KEYS:
        raise SpecError(f"top-level keys {sorted(spec)}, expected {sorted(TOP_KEYS)}")
    cmd, paths = spec["command"], spec["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise SpecError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise SpecError(f"command word {word!r} leaves the checkout")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise SpecError("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.fullmatch(p) or p.startswith("/") or ".." in p.split("/") or not (root / p).is_dir():
            raise SpecError(f"path {p!r}: a relative directory of the checkout")
    if not (isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51):
        raise SpecError("run_seconds: a whole number from 1 to 51")
    if len(json.dumps(spec)) > 64 * 1024:
        raise SpecError("BENCHMARK.json is over 64 KiB")

    def unique(entries, what):
        names = [e["name"] for e in entries]
        if len(set(names)) != len(names):
            raise SpecError(f"{what}: a name appears twice")

    configs = spec["configs"]
    if not 1 <= len(configs) <= 24:
        raise SpecError("configs: 1 to 24")
    for c in configs:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')}")
        _name(c["name"], "config name")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        f = Path(c["file"])
        if not any(f.parts[:len(Path(p).parts)] == Path(p).parts for p in paths) or not (root / f).is_file():
            raise SpecError(f"config file {c['file']!r}: a file under paths")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError("reduced: a list of at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
    unique(configs, "configs")
    if len({c["file"] for c in configs}) != len(configs):
        raise SpecError("two configurations share a file")

    cells = spec["workloads"]
    if not 1 <= len(cells) <= 24:
        raise SpecError("workloads: 1 to 24")
    cfg_names = {c["name"] for c in configs}
    pairs = set()
    for c in cells:
        _keys(c, CELL_KEYS, f"cell {c.get('name')}")
        _name(c["name"], "cell name")
        _name(c["traffic"], "traffic")
        _line(c["why"], "cell why")
        if c["config"] not in cfg_names:
            raise SpecError(f"cell {c['name']}: unknown configuration {c['config']!r}")
        if c["chips"] not in (1, 4):
            raise SpecError(f"cell {c['name']}: chips 1 or 4")
        if (c["config"], c["traffic"]) in pairs:
            raise SpecError(f"cell {c['name']}: configuration and traffic already paired")
        pairs.add((c["config"], c["traffic"]))
        tf = traffic_file(root, c["traffic"])
        if not tf.is_file():
            raise SpecError(f"cell {c['name']}: no traffic file {tf.relative_to(root)}")
        kind = json.loads(tf.read_text()).get("kind", "")
        _name(kind, "traffic kind")
        if not kind_file(root, kind).is_file():
            raise SpecError(f"traffic {c['traffic']}: no driver {kind_file(root, kind).relative_to(root)}")
    unique(cells, "workloads")
    if sum(c["chips"] == 4 for c in cells) > max(1, len(cells) // 4):
        raise SpecError("more than a quarter of the cells ask for 4 chips")
    unused = cfg_names - {c["config"] for c in cells}
    if unused:
        raise SpecError(f"configurations no cell uses: {sorted(unused)}")

    cell_names = {c["name"] for c in cells}
    e2e, layer = spec["end_to_end"], spec["per_layer"]
    if not 1 <= len(e2e) <= 16 or not 1 <= len(layer) <= 128:
        raise SpecError("end_to_end: 1 to 16 metrics; per_layer: 1 to 128")
    unique(e2e + layer, "metrics")
    for m in e2e + layer:
        is_e2e = m in e2e
        _keys(m, E2E_KEYS if is_e2e else LAYER_KEYS, f"metric {m.get('name')}", ("workloads",))
        _name(m["name"], "metric name")
        if not UNIT.fullmatch(m["unit"]):
            raise SpecError(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise SpecError(f"metric {m['name']}: better is lower or higher")
        if m["source"] not in (("host_clock", "device_trace") if is_e2e else SOURCES):
            raise SpecError(f"metric {m['name']}: source {m['source']!r}")
        if not set(m.get("workloads", [])) <= cell_names or ("workloads" in m and not m["workloads"]):
            raise SpecError(f"metric {m['name']}: workloads must name cells")
        if is_e2e and not (isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25):
            raise SpecError(f"metric {m['name']}: bound from 0.01 to 0.25")
    if "setup_s" not in {m["name"] for m in e2e}:
        raise SpecError("end_to_end has no setup_s")
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        _line(m["layer"], f"metric {m['name']} layer")
        if m["moves"] not in e2e_names:
            raise SpecError(f"metric {m['name']}: moves {m['moves']!r}, not an end-to-end metric")
        if not metric_file(root, m["name"]).is_file():
            raise SpecError(f"metric {m['name']}: no reader {metric_file(root, m['name']).relative_to(root)}")
        for w in m.get("workloads", []):
            if m["moves"] not in {e["name"] for e in end_to_end(spec, w)}:
                raise SpecError(f"metric {m['name']}: cell {w} does not report {m['moves']}")
    for c in cells:
        names = {m["name"] for m in end_to_end(spec, c["name"])}
        if "setup_s" not in names or len(names) < 2 or not per_layer(spec, c["name"]):
            raise SpecError(f"cell {c['name']}: needs setup_s, another end-to-end metric and a per-layer one")
