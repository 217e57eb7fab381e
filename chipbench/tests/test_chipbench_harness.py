"""The harness: cells found by name, the file's names and units, the
guard against JAX, and no result without a card."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

from chipbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_by_files_and_entries_only(tmp_path):
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "chipbench")
    here = tmp_path / "chipbench"
    cfg = json.loads((here / "configs" / "starcoder2-3b.json").read_text())
    cfg["model"]["n_layers"] = 2
    (here / "configs" / "starcoder2-3b-2l.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "train-session-b4-t2048.json").read_text())
    mix["seq"] = 1024
    (here / "traffic" / "train-session-b4-t1024.json").write_text(json.dumps(mix))
    (here / "limits" / "starcoder2-2l-train-1k.json").write_text(
        (here / "limits" / "starcoder2-train-2k.json").read_text())
    (here / "metrics" / "steps_in_window.py").write_text(
        "def read(r):\n    return r.get('steps')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="starcoder2-3b-2l",
                                 file="chipbench/configs/starcoder2-3b-2l.json"))
    bench["workloads"].append({"name": "starcoder2-2l-train-1k", "config": "starcoder2-3b-2l",
                               "traffic": "train-session-b4-t1024", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("starcoder2-2l-train-1k")
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["starcoder2-2l-train-1k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("starcoder2-2l-train-1k", root=tmp_path, here=here)
    assert cell.config["model"]["n_layers"] == 2 and cell.traffic["seq"] == 1024
    assert harness.kind(cell).__name__ == "chipbench_kind_train"
    assert harness.reference(cell).prefill
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window"]
    assert harness.metric_reader(cell, "steps_in_window").read({"steps": 7}) == 7
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_names_units_and_entries_are_well_formed():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for section, keys in KEYS.items():
        for entry in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("chipbench/")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "chipbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        assert (ROOT / "chipbench" / "limits" / f"{w}.json").is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024
    for p in (ROOT / "chipbench").rglob("*"):
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_a_configs_leaves_add_up_to_its_stated_parameters(config):
    import math
    from chipbench import weights as W
    cfg = json.loads((ROOT / "chipbench" / "configs" / f"{config}.json").read_text())
    assert sum(math.prod(s.shape) for s in W.param_specs(cfg["model"])) == cfg["params_total"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "chipbench").rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))
    for path in sorted((ROOT / "chipbench" / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "math", "random", "typing", "torch", "numpy"}, (path, tops)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in harness.forbidden_modules()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_no_card_means_no_result(workload):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chipbench/run.py", "--workload", workload,
                        "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_result_line_keys_and_checks_last(monkeypatch):
    cell = harness.load_cell("starcoder2-train-2k")
    out = harness.Outcome(attempted=3, failed=0,
                          end_to_end={"train_tokens_per_s": 1.5, "setup_s": 2.0},
                          readings={}, checks=[harness.Check("loss_rel_gap", 0.1, 0.2)],
                          memory_peak_bytes=10)
    monkeypatch.setattr(harness, "device_info", lambda count, peak: {
        "platform": "gpu", "kind": "none", "count": count, "memory_peak_bytes": peak})
    line = harness.result(cell, out, trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    out.checks.append(harness.Check("grad1_leaf_gap", float("nan"), 1.0))
    assert harness.result(cell, out, trace=False)["correct"] is False
