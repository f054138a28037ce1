"""BENCHMARK.json against the benchmark's contract, the harness's imports,
its refusal without a card, and a new cell added by files alone."""

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "sudo_rm_rf_tpu"}


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (core.ROOT / c["file"]).is_file()
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        conf = core.load_json(core.ROOT / c["file"])
        assert all(k in conf for k in c["reduced"]) and conf["reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert LINE.match(w["why"]) and NAME.match(w["traffic"])
        tr = core.load_json(core.HERE / "traffic" / f"{w['traffic']}.json")
        assert (core.HERE / "drivers" / f"{tr['driver']}.py").is_file()
        assert tr["limits"] and all(v > 0 for v in tr["limits"].values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        assert (core.HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:  # each cell it lists reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in BENCH["workloads"]:
        cell = core.load_cell(w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(core.HERE.rglob("*.py")), ids=lambda p: str(p.name))
def test_no_jax_and_a_reference_apart_from_the_program(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "sudo_rm_rf_tpu_torch" not in tops


def test_a_run_loads_no_jax():
    code = (
        "import sys, json, torch\n"
        "from perfbench import core, run\n"
        "from perfbench.tests.conftest import toy_cell, SERVE\n"
        "r = run.run_cell(toy_cell('offline_batch32_4s', **SERVE), 2**33 + 1, 0.2, False, 'cpu')\n"
        "print(json.dumps({'correct': r['correct'], 'found': core.forbidden_loaded(),\n"
        "  'tops': sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'flax'})}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "tops": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sudo_rm_rf_tpu_torch_fake", object())
    assert "sudo_rm_rf_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.forbidden_loaded() == ["jax"]


def _cli(args, cwd):
    return subprocess.run([sys.executable, "-m", "perfbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _cli(["--workload", "u16-batch32", "--seed", "1", "--seconds", "1"], core.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "is_available() is False" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    out = _cli(["--workload", "u16-batch32", "--seed", "1", "--seconds", "1"], tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_added_by_files_alone(tmp_path):
    """A toy configuration, traffic mix and per-layer metric, each a new file
    and a new entry: the harness's own files stay as they are."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "sudo_rm_rf_tpu_torch").symlink_to(core.ROOT / "sudo_rm_rf_tpu_torch")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    conf = dict(json.loads((core.HERE / "configs" / "improved_u16_b512.json").read_text()))
    conf.update(out_channels=16, in_channels=32, num_blocks=2, upsampling_depth=3,
                enc_num_basis=32)
    (root / "perfbench/configs/toy_u2.json").write_text(json.dumps(conf))
    traffic = dict(core.load_json(core.HERE / "traffic" / "offline_batch32_4s.json"),
                   batch=2, ring=2, sample=2, seconds_per_example=0.25)
    (root / "perfbench/traffic/toy_batch2.json").write_text(json.dumps(traffic))
    (root / "perfbench/metrics/toy_batches.py").write_text(
        "def read(tr):\n    return float(tr.units)\n")
    bench["configs"].append({"name": "toy_u2", "source": "https://arxiv.org/abs/2103.02644",
                             "file": "perfbench/configs/toy_u2.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy_u2", "traffic": "toy_batch2",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"][0]["workloads"].append("toy-cell")
    bench["per_layer"].append({"name": "toy_batches", "unit": "batches", "better": "higher",
                               "source": "program_counter", "layer": "toy",
                               "moves": "serve_audio_s_per_s", "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json\n"
        "from perfbench import core, run\n"
        "cell = core.load_cell('toy-cell')\n"
        "line = run.run_cell(cell, 7, 0.2, False, 'cpu')\n"
        "trace = run.tr.Trace([], 1.0, units=3)\n"
        "print(json.dumps([line, run.per_layer_metrics(cell, trace)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    line, per_layer = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"serve_audio_s_per_s", "setup_s"}
    assert math.isfinite(line["metrics"]["serve_audio_s_per_s"]["value"])
    # the new per-layer metric is found by its name; the cell's others find no
    # device events in this trace and are left out
    assert per_layer == {"toy_batches": {"value": 3.0, "unit": "batches"}}
    for p, data in before.items():
        assert p.read_bytes() == data, p
