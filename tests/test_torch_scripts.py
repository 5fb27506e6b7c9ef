"""The port's scale runs (colmap_tpu_torch/scripts/) against the JAX
package's scripts/ on the CPU: scale_run and scaling_curve here,
full_scale_run and benchmark_reconstruction in
test_torch_scripts_images.py (the two files run on two workers).

Each test loads the JAX script from its path, runs it with `sys.argv`
set, and runs the port's module on the same arguments plus `--device
cpu`, each in a workspace of its own. Held:
- scale_run, incremental (24 images, 20 points each seen by 8 cameras,
  chained matches of overlap 4): both exit 0; the port's report has the
  JAX report's keys plus `device` and `ba_stats`; `num_images`,
  `gt_points` and `gt_obs` equal (the synthetic databases are equal);
  both within the script's gates (>= 95% registered, 1 deg, 0.05); the
  port's sparse/ reads back;
- scale_run, hierarchical with leaves of 12 (a split and a merge), the
  port's run loading the incremental run's `--db_cache`: the same;
- a mapper that raises: the traceback in the report, exit 1; `--device
  cuda` with no card raises;
- scaling_curve on a cut problem (48 poses, 12,000 observations) at 1
  and 2 CPU shards: the JAX report's keys; the BA cost on 2 shards within
  1e-3 relative of 1 shard (the multi-device tests' tolerance); the
  matches on 2 shards equal to 1 shard's and >= 0.999 equal to JAX's (the
  matcher's tie allowance);
- `python -m colmap_tpu_torch.scripts.<name> --device cpu` imports
  neither jax nor colmap_tpu (read from `-X importtime`).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from colmap_tpu_torch.scene import reconstruction_io as rio
from colmap_tpu_torch.scripts import scale_run as tscale
from colmap_tpu_torch.scripts import scaling_curve as tcurve

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE_ARGS = ["--num_images", "24", "--points_per_image", "20",
              "--visibility_images", "8", "--overlap", "4"]
# the keys the port's reports add to the JAX scripts' on the CPU
PORT_KEYS = {"scale_run": {"device", "ba_stats"},
             "scale_run_hierarchical": {"device", "ba_stats",
                                        "stage_seconds",
                                        "hierarchical_seconds"},
             "full_scale_run": {"device", "k1_launches"},
             "benchmark_reconstruction": {"device", "stage_seconds",
                                          "k1_launches"}}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(monkeypatch, name, args) -> int:
    """The JAX script's exit code, from its return value or SystemExit."""
    mod = _jax_script(name)
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [name + ".py"] + list(args))
        try:
            return mod.main() or 0
        except SystemExit as e:
            return e.code or 0


def _read(path):
    with open(path) as fp:
        return json.load(fp)


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _gates(rep, n_images):
    assert rep["ok"] is True, rep.get("reason")
    assert rep["num_registered"] >= 0.95 * n_images
    assert rep["max_rotation_error_deg"] <= 1.0
    assert rep["max_center_error"] <= 0.05


def _held_to_jax(jrep, trep, added, n_images):
    assert set(trep) - set(jrep) == added
    assert set(jrep) <= set(trep)
    for k in ("num_images", "gt_points", "gt_obs", "mode"):
        assert trep[k] == jrep[k], k
    _gates(jrep, n_images)
    _gates(trep, n_images)


# ---------------------------------------------------------------------------
# scale_run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def incremental(tmp_path_factory):
    """Both packages' incremental scale runs; the port's with a cache."""
    root = tmp_path_factory.mktemp("scale")
    mp = pytest.MonkeyPatch()
    try:
        rc_j = _run_jax(mp, "scale_run", SCALE_ARGS + [
            "--workspace", str(root / "jax")])
    finally:
        mp.undo()
    cache = str(root / "cache.db")
    rc_t = tscale.main(SCALE_ARGS + ["--workspace", str(root / "port"),
                                     "--db_cache", cache, "--device", "cpu"])
    return dict(root=root, cache=cache, rc_j=rc_j, rc_t=rc_t,
                jrep=_read(root / "jax" / "report.json"),
                trep=_read(root / "port" / "report.json"))


def test_scale_run_incremental_matches_jax(incremental):
    r = incremental
    assert r["rc_j"] == 0 and r["rc_t"] == 0
    _held_to_jax(r["jrep"], r["trep"], PORT_KEYS["scale_run"], 24)
    trep = r["trep"]
    assert trep["device"] == "cpu"
    assert trep["ba_stats"]["gba_calls"] >= 1
    assert set(trep["stage_seconds"]) >= {"register", "global_ba"}
    rec = rio.read_model(r["root"] / "port" / "sparse")
    assert rec.num_registered_images() == trep["num_registered"]
    assert len(rec.points3D) == trep["num_points3D"]
    # the cache: the database and its ground-truth model
    assert os.path.isfile(r["cache"])
    assert rio.read_model(r["cache"] + ".gt").num_registered_images() == 24


def test_scale_run_hierarchical_from_db_cache_matches_jax(
        incremental, tmp_path, monkeypatch):
    args = SCALE_ARGS + ["--mode", "hierarchical", "--leaf_max_images", "12"]
    assert _run_jax(monkeypatch, "scale_run", args + [
        "--workspace", str(tmp_path / "jax")]) == 0
    rc = tscale.main(args + ["--workspace", str(tmp_path / "port"),
                             "--db_cache", incremental["cache"],
                             "--device", "cpu"])
    assert rc == 0
    jrep = _read(tmp_path / "jax" / "report.json")
    trep = _read(tmp_path / "port" / "report.json")
    _held_to_jax(jrep, trep, PORT_KEYS["scale_run_hierarchical"], 24)
    # loaded from the cache: the same ground truth as the run that wrote it
    assert trep["gt_obs"] == incremental["trep"]["gt_obs"]
    assert trep["synth_s"] <= incremental["trep"]["synth_s"] + 0.1
    # split into leaves, then merged
    assert trep["hierarchical_seconds"]["pose_graph"] >= 0.0
    assert trep["hierarchical_seconds"]["clustering"] >= 0.0
    rec = rio.read_model(tmp_path / "port" / "sparse")
    assert rec.num_registered_images() == trep["num_registered"]


def test_scale_run_failure_exits_nonzero(tmp_path, monkeypatch):
    from colmap_tpu_torch.controllers import incremental_pipeline

    def boom(self, *a, **k):
        raise RuntimeError("mapper failed on purpose")

    monkeypatch.setattr(incremental_pipeline.IncrementalPipeline, "run",
                        boom)
    rc = tscale.main(["--num_images", "8", "--visibility_images", "4",
                      "--overlap", "2", "--workspace", str(tmp_path),
                      "--device", "cpu"])
    rep = _read(tmp_path / "report.json")
    assert rc == 1 and rep["ok"] is False
    assert rep["reason"] == "mapper failed on purpose"
    assert "RuntimeError: mapper failed on purpose" in rep["traceback"]


def test_scripts_ask_for_a_card_and_find_none(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tscale.main(["--num_images", "8", "--workspace", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcurve.main(["--out", str(tmp_path / "c.json")])


# ---------------------------------------------------------------------------
# scaling_curve
# ---------------------------------------------------------------------------


def test_scaling_curve_matches_jax_keys_and_one_shard(tmp_path,
                                                      monkeypatch):
    import jax

    import __graft_entry__
    from colmap_tpu.parallel import mesh as jmesh
    from colmap_tpu.parallel import sharded_matching as jsm

    # 12,000 observations: 5 LM iterations leave the cost well above 0
    cut = dict(num_poses=48, num_points=2000, obs_per_point=6, seed=7)
    # the JAX script on its one-device curve over the cut BA problem
    build = __graft_entry__._build_problem
    monkeypatch.setattr(__graft_entry__, "_build_problem",
                        lambda **kw: build(**cut))
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    assert _run_jax(monkeypatch, "scaling_curve",
                    ["--out", str(tmp_path / "jax.json")]) == 0
    jrep = _read(tmp_path / "jax.json")

    monkeypatch.setattr(tcurve, "MESH_SIZES", (1, 2))
    monkeypatch.setattr(tcurve, "BA_PROBLEM", cut)
    monkeypatch.setattr(tcurve, "REPS", 1)
    assert tcurve.main(["--device", "cpu",
                        "--out", str(tmp_path / "port.json")]) == 0
    trep = _read(tmp_path / "port.json")
    assert set(trep) - set(jrep) == {"device", "mesh_sizes"}
    assert set(jrep) <= set(trep)
    for part in ("ba", "matcher"):
        assert set(jrep[part]) == set(trep[part])
        assert set(jrep[part]["curve"]["1"]) <= set(trep[part]["curve"]["1"])
    assert trep["ba"]["problem"] == jrep["ba"]["problem"]
    assert trep["matcher"]["problem"] == jrep["matcher"]["problem"]
    assert trep["mesh_sizes"] == {"ran": [1, 2], "cut": {}}
    c1 = trep["ba"]["curve"]["1"]["cost"]
    c2 = trep["ba"]["curve"]["2"]["cost"]
    assert abs(c2 - c1) <= 1e-3 * c1
    assert trep["ba"]["curve"]["2"]["collective_share"] > 0.0

    # matches: 2 shards equal 1, and JAX's on its 2-device mesh
    rng = np.random.default_rng(0)
    d1 = rng.integers(0, 255, (4, 256, 128)).astype(np.uint8)
    d2 = rng.integers(0, 255, (4, 256, 128)).astype(np.uint8)
    v = np.ones((4, 256), bool)
    one, two = (tcurve.bench_matcher_at(m, d1, d2, v, v, 1)["matches"]
                for m in tcurve.mesh_sizes("cpu", (1, 2))[0])
    np.testing.assert_array_equal(one, two)
    ref = jsm.match_pair_blocks_sharded(jmesh.make_mesh(2), d1, d2, v, v)
    assert (ref == two).mean() >= 0.999


# ---------------------------------------------------------------------------
# no jax in the port's scripts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("scale_run", ["--num_images", "12", "--visibility_images", "6",
                   "--overlap", "3"]),
    ("full_scale_run", ["--num_images", "2", "--width", "96", "--height",
                        "72"]),
    ("benchmark_reconstruction", ["--dataset_path", "."]),
    ("scaling_curve", ["--help"]),
])
def test_script_imports_neither_jax_nor_colmap_tpu(name, args, tmp_path):
    if name in ("scale_run", "full_scale_run"):
        args = args + ["--workspace", str(tmp_path / "ws")]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         f"colmap_tpu_torch.scripts.{name}", "--device", "cpu"] + args,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=env)
    imported = [ln.rsplit("|", 1)[-1].strip() for ln in
                res.stderr.splitlines() if ln.startswith("import time:")]
    assert any(m.startswith("colmap_tpu_torch.scripts") for m in imported)
    bad = [m for m in imported if m.split(".")[0] in ("jax", "colmap_tpu")]
    assert not bad, bad
    # each ran to its own end: a report, a missing ground truth, the help
    assert res.returncode in {"scale_run": (0,), "full_scale_run": (1,),
                              "benchmark_reconstruction": (2,),
                              "scaling_curve": (0,)}[name], res.stderr[-2000:]
