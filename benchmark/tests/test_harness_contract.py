"""BENCHMARK.json against the benchmark's contract, and the harness finding
configurations, cells, traffic kinds and metrics by name."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|experts_per_tok|width)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # the full check with 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in SPEC["end_to_end"])


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not WIDTHS.search(key)


def test_cells_match_their_files():
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        four += w["chips"] == 4
        cell = harness.cell_file(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell[k] == w[k], (w["name"], k)
        harness.config_file(cell["config"])
        mod = harness.traffic_module(cell["traffic"])
        for fn in ("setup", "window", "outputs", "judge"):
            assert callable(getattr(mod, fn))
        assert cell["limits"]
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])


def test_every_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        got = harness.cell_metrics(SPEC, w["name"])
        e2e = {m["name"] for m in got["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert got["per_layer"]


def test_every_metric_moves_an_end_to_end_metric_of_its_cells():
    for m in SPEC["per_layer"]:
        assert m["workloads"]
        for w in m["workloads"]:
            e2e = {x["name"] for x in
                   harness.cell_metrics(SPEC, w)["end_to_end"]}
            assert m["moves"] in e2e, (m["name"], w)


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A new configuration, cell, traffic kind and metric: new files and
    new BENCHMARK.json entries only."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "new_config.json").write_text(json.dumps(
        {"reduced": [], "source": "x"}))
    (bench / "workloads" / "new_config.echo.json").write_text(json.dumps(
        {"config": "new_config", "traffic": "echo", "chips": 1, "why": "x",
         "params": {"n": 3}, "limits": {"n": 3}}))
    (bench / "traffic" / "echo.py").write_text(
        "def setup(run): pass\n"
        "def window(run): run.totals.update(window_s=1.0, n=run.params['n'])\n"
        "def outputs(run): pass\n"
        "def judge(run, control=False): return []\n")
    (bench / "metrics" / "echo.n_per_s.py").write_text(
        "def read(run):\n    return run.totals.get('n')\n")
    monkeypatch.setattr(harness, "BENCH_DIR", str(bench))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "new_config.echo",
                              "config": "new_config", "traffic": "echo",
                              "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "echo.n_per_s", "unit": "n/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["new_config.echo"]})
    cell = harness.cell_file("new_config.echo")
    assert harness.config_file(cell["config"])["source"] == "x"
    mod = harness.traffic_module("echo")
    run = harness.Run("new_config.echo", cell, 1, 1.0, False, "cpu", 1,
                      str(tmp_path), harness.Tracer(False, lambda: None))
    mod.window(run)
    got = harness.cell_metrics(spec, "new_config.echo")
    names = [m["name"] for m in got["end_to_end"]]
    assert names == ["setup_s", "echo.n_per_s"]
    assert harness.metric_module("echo.n_per_s").read(run) == 3


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_a_cells_modules_load_no_jax():
    code = (
        "import sys\n"
        "from benchmark import harness, run\n"
        "spec = harness.benchmark_spec()\n"
        "for w in spec['workloads']:\n"
        "    harness.traffic_module(w['traffic'])\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        "    harness.metric_module(m['name'])\n"
        "import colmap_tpu_torch.controllers.dense_reconstruction\n"
        "print(harness.forbidden_loaded())\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import benchmark.reference.dense\n"
        "print(sorted({m.split('.')[0] for m in sys.modules\n"
        "              if m.split('.')[0].startswith('colmap_tpu')\n"
        "              or m.split('.')[0] in ('jax', 'jaxlib')}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            text = open(os.path.join(ref, name)).read()
            assert not re.search(r"^\s*(from|import)\s+colmap_tpu", text,
                                 re.M), name
            assert "benchmark.traffic" not in text
            assert "benchmark.inputs" not in text


def test_forbidden_names_are_compared_whole():
    mods = {"colmap_tpu_torch": 1, "colmap_tpu_torch.cli": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(dict(mods, **{"jax.numpy": 1})) == ["jax"]
    assert harness.forbidden_loaded({"colmap_tpu.features": 1}) == [
        "colmap_tpu"]


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 11),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_with_only_the_benchmarks_files_a_run_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        SPEC["command"][:1] and [sys.executable] + SPEC["command"][1:]
        + ["--workload", SPEC["workloads"][0]["name"], "--seed", "5",
           "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_checks_compare_in_their_sense():
    assert harness.Check("a", 1.0, 2.0).ok
    assert not harness.Check("a", 3.0, 2.0).ok
    assert harness.Check("b", 3.0, 2.0, at_most=False).ok
    assert not harness.Check("a", math.nan, 2.0).ok


def test_union_and_breakdown():
    tr = harness.Tracer(False, lambda: None)
    tr.device_ops = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0)]
    tr.host_ops = [("outer", 0.0, 60.0), ("inner", 25.0, 35.0)]
    assert harness.union_seconds(tr.device_ops) == pytest.approx(30e-6)
    b = harness.breakdown(tr)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["inner", pytest.approx(20e-6)]


def test_profiler_ranges_are_not_device_time():
    import torch

    tr = harness.Tracer(True, lambda: None)

    class Owner:
        @staticmethod
        def work(x):
            return x + 1

    undo = tr.label(Owner, "work", "bench.work")
    tr.start()
    Owner.work(torch.ones(4))
    tr.stop()
    undo()
    assert "bench.work" in [n for n, _, _ in tr.host_ops]
    assert not [n for n, _, _ in tr.device_ops if n == "bench.work"]
    assert Owner.work(1) == 2
