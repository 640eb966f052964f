"""The result line and BENCHMARK.json against the benchmark's contract, on
the CPU: the keys and types of a run's last line (with and without a
trace), the checks as its last key, the spec's names, units, bounds and
files, a reader for every metric, and a refusal without a card."""
import json
import os
import re
import subprocess
import sys

import pytest

from helpers import ROOT, cpu_run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _check_result(r, trace):
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    assert isinstance(r["attempted"], int) and isinstance(r["failed"], int)
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][key]) <= 10
    for name, c in r["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("workload,trace", [("sgv_tiny.synth16f", False),
                                            ("sgv_tiny.synth16f", True),
                                            ("sgv_tiny.train", False)])
def test_result_line_schema(workload, trace):
    r = cpu_run(workload, trace=trace)
    _check_result(r, trace)
    assert r["correct"]
    if not trace:
        assert "setup_s" in r["metrics"]


def test_benchmark_json_follows_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(c["reduced"]) <= set(json.load(f))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        for path in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(ROOT, "benchmark", path))
        names.add(w["name"])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and set(m.get("workloads", names)) <= names
        base = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{base}.py"))
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        for w in m.get("workloads", names):
            assert any(w in e.get("workloads", names) for e in spec["end_to_end"]
                       if e["name"] == m["moves"])
    for w in names:                     # every cell reports setup_s, another metric, a layer's
        assert sum(w in m.get("workloads", names) for m in spec["end_to_end"]) >= 2
        assert any(w in m.get("workloads", names) for m in spec["per_layer"])
    assert len(json.dumps(spec)) <= 64 * 1024


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sgv_ffs256.synth16f",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
