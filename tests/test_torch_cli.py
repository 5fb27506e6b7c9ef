"""The port's command line, option manager and database tools against the
JAX package's, in one process on the CPU (`--device cpu` for the port).

Held:
- the same command names, and per command the same argparse flags with
  the same defaults, except the port's `--device` and the JAX package's
  `--Mapper.max_round_retries` / `--Mapper.retry_cooldown_s` (the round
  catch-and-retry the port does not have);
- the option manager's one-key-one-target rule, and project .ini files
  both ways: a JAX-written file reads into the port with equal values
  (the two retry keys dropped with one log line naming them) and the
  port's file reads into JAX with equal values; for the same values the
  two files differ only by those two lines;
- on an 8-image `synthesize_dataset` database (the port's generator,
  byte-equal to JAX's) and its ground-truth model: model_converter,
  model_cropper and model_splitter write byte-equal files, model_merger
  byte-equal cameras and images and the same points within 1e-4 (they
  pass through a float32 robust Sim3; tests/test_torch_model_tools.py's
  merge tolerance);
  model_transformer's model within 1e-5 (the same file's tolerance);
  model_analyzer prints the same numbers, model_comparer the same image
  count and centre error within 1e-5 and rotation error within 0.02 deg
  (float32 arccos near 1, as there);
  point_triangulator's points within 1e-3 of JAX's (as there);
- database_creator, database_cleaner, database_merger, image_deleter,
  image_filterer and feature_importer leave the same rows in every table;
  matches_importer (which matches and verifies the imported pairs again)
  the same `matches` rows and the same verified pairs, configs and, by
  outcome, inlier matches (>= 95% of the union shared; RANSAC draws
  differ);
- `python -m colmap_tpu_torch help` lists the commands.
The pixels-to-model chain of both command lines is
tests/test_torch_cli_chain.py.
"""

import argparse
import copy
import dataclasses
import json
import logging
import os
import shutil
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from colmap_tpu import cli as jcli
from colmap_tpu.controllers import option_manager as jom
from colmap_tpu.scene import reconstruction_io as jrio
from colmap_tpu_torch import cli as tcli
from colmap_tpu_torch.controllers import option_manager as tom
from colmap_tpu_torch.scene import reconstruction_io as trio
from colmap_tpu_torch.scene import synthetic
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.sensor import bitmap

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ONLY = {"--device"}
JAX_ONLY = {"--Mapper.max_round_retries", "--Mapper.retry_cooldown_s"}


@pytest.fixture(scope="module")
def gt_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    db_path = str(root / "database.db")
    db = Database(db_path)
    gt = synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
        num_cameras=1, num_images=8, num_points3D=150, seed=4), db)
    db.close()
    model_dir = str(root / "model")
    os.makedirs(model_dir)
    trio.write_model(gt, model_dir, ext=".bin")
    return dict(root=root, db_path=db_path, model_dir=model_dir, gt=gt)


# ---------------------------------------------------------------------------
# commands, flags, option manager
# ---------------------------------------------------------------------------


def test_command_names_equal_jax():
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS)
    assert len(tcli.COMMANDS) == 43


class _Parsed(Exception):
    pass


def _parser_of(cli_mod, name, monkeypatch):
    """The argparse parser a command builds, caught at parse_args."""
    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        cli_mod.COMMANDS[name]([])
    except _Parsed as e:
        return e.args[0]
    except SystemExit:  # gui exits before it parses
        return None
    finally:
        monkeypatch.undo()
    return None


def _flags(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.required, a.choices,
                                  getattr(a.type, "__name__", None))
            for a in parser._actions if a.option_strings
            and a.option_strings[0] not in ("-h",)}


@pytest.mark.parametrize("name", sorted(jcli.COMMANDS))
def test_command_flags_equal_jax(name, monkeypatch):
    jp = _parser_of(jcli, name, monkeypatch)
    tp = _parser_of(tcli, name, monkeypatch)
    if jp is None:  # gui: no parser, the same exit
        assert tp is None
        with pytest.raises(SystemExit) as je:
            jcli.COMMANDS[name]([])
        with pytest.raises(SystemExit) as te:
            tcli.COMMANDS[name]([])
        assert str(te.value) == str(je.value)
        return
    jf, tf = _flags(jp), _flags(tp)
    assert set(tf) - set(jf) == PORT_ONLY
    assert set(jf) - set(tf) == JAX_ONLY
    for flag in set(jf) & set(tf):
        assert tf[flag] == jf[flag], flag
    assert tf["--device"][1] == "cuda"


def test_option_manager_flat_key_routes_once():
    """A flat key shared by several nested option groups updates only ONE
    of them (the first in field order), mirroring _scalar_items'
    collision rule (tests/test_cli_tools.py's case, on the port)."""
    @dataclasses.dataclass
    class SubA:
        shared: int = 1
        only_a: int = 10

    @dataclasses.dataclass
    class SubB:
        shared: int = 2
        deep_only: int = 20

    @dataclasses.dataclass
    class SubC:
        nested: SubB = dataclasses.field(default_factory=SubB)

    @dataclasses.dataclass
    class Top:
        own: int = 0
        a: SubA = dataclasses.field(default_factory=SubA)
        b: SubB = dataclasses.field(default_factory=SubB)
        c: SubC = dataclasses.field(default_factory=SubC)

    top = tom._apply_updates(Top(), {"shared": 99, "own": 5})
    assert top.own == 5
    assert top.a.shared == 99
    assert top.b.shared == 2
    names = [n for n, _ in tom._scalar_items(Top())]
    assert "deep_only" in names
    assert names.count("shared") == 1
    top2 = tom._apply_updates(Top(), {"nested": 1})
    assert top2.c.nested.shared == 2


def _values(om):
    out = {"database_path": om.database_path, "image_path": om.image_path}
    for section, obj in om.options.items():
        for name, v in tom._scalar_items(obj):
            out[f"{section}.{name}"] = v
    return out


_CHANGES = ["--database_path", "/data/db.db", "--image_path", "/data/img",
            "--SiftExtraction.max_num_features", "1234",
            "--SiftExtraction.estimate_affine_shape", "1",
            "--SiftExtraction.dsp_num_scales", "7",
            "--ImageReader.camera_model", "PINHOLE",
            "--FeatureMatching.min_num_inliers", "20",
            "--SiftMatching.max_ratio", "0.75",
            "--Mapper.init_min_num_inliers", "80",
            "--Mapper.ba_global_images_ratio", "1.3",
            "--Mapper.extract_colors", "1",
            "--Mapper.num_threads", "4",
            "--PatchMatchStereo.window_radius", "4",
            "--StereoFusion.min_num_pixels", "3"]


def test_project_ini_round_trips_between_packages(tmp_path, caplog):
    j_ini, t_ini = str(tmp_path / "jax.ini"), str(tmp_path / "port.ini")
    assert jcli.main(["project_generator", "--output_path", j_ini]
                     + _CHANGES + ["--Mapper.max_round_retries", "5"]) == 0
    assert tcli.main(["project_generator", "--output_path", t_ini]
                     + _CHANGES) == 0
    # the port's file is the JAX file without the two retry lines
    j_lines = open(j_ini).read().splitlines()
    assert [l for l in j_lines
            if l.split(" = ")[0] not in ("max_round_retries",
                                         "retry_cooldown_s")] \
        == open(t_ini).read().splitlines()
    assert not [l for l in open(t_ini) if l.startswith("device")]

    caplog.set_level(logging.INFO, logger="colmap_tpu_torch")
    t_om = tom.OptionManager()
    t_om.read(j_ini)
    dropped = [r for r in caplog.records if "dropped" in r.getMessage()]
    assert len(dropped) == 1
    assert "Mapper.max_round_retries" in dropped[0].getMessage()
    assert "Mapper.retry_cooldown_s" in dropped[0].getMessage()
    j_om = jom.OptionManager()
    j_om.read(j_ini)
    tv, jv = _values(t_om), _values(j_om)
    assert {k for k in jv if k not in tv} == {
        "Mapper.max_round_retries", "Mapper.retry_cooldown_s"}
    assert {k: jv[k] for k in tv} == tv
    assert tv["SiftExtraction.max_num_features"] == 1234
    assert tv["Mapper.extract_colors"] is True

    # and the port's file into JAX
    j2 = jom.OptionManager()
    j2.read(t_ini)
    j2v = _values(j2)
    assert {k: j2v[k] for k in tv} == tv
    assert j2v["Mapper.max_round_retries"] == 3  # JAX's default


# ---------------------------------------------------------------------------
# model commands
# ---------------------------------------------------------------------------


def _files(path):
    if os.path.isfile(path):
        return {"": open(path, "rb").read()}
    return {os.path.relpath(os.path.join(d, f), path):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(path) for f in fs}


def _both(args, tmp_path, outs=("--output_path",), device=True):
    """Run the JAX and the port CLI with `args`; every flag in `outs` gets
    a path under tmp_path/jax resp. tmp_path/port. Returns both roots."""
    roots = {}
    for tag, mod in (("jax", jcli), ("port", tcli)):
        root = tmp_path / tag
        root.mkdir(exist_ok=True)
        argv = []
        for i, a in enumerate(args):
            if i > 0 and args[i - 1] in outs:
                a = str(root / a)
            argv.append(a)
        if tag == "port" and device:
            argv += ["--device", "cpu"]
        assert mod.main(argv) == 0, (tag, argv)
        roots[tag] = root
    return roots["jax"], roots["port"]


@pytest.mark.parametrize("fmt,out", [("TXT", "txt"), ("BIN", "bin"),
                                     ("PLY", "m.ply"), ("NVM", "m.nvm"),
                                     ("Bundler", "m.out"),
                                     ("VRML", "m.wrl"), ("HTML", "m.html")])
def test_model_converter_byte_equal(gt_model, tmp_path, fmt, out):
    j, t = _both(["model_converter", "--input_path", gt_model["model_dir"],
                  "--output_path", out, "--output_type", fmt], tmp_path)
    assert _files(str(t / out)) == _files(str(j / out))
    assert _files(str(t / out))


def test_model_cropper_splitter_merger_byte_equal(gt_model, tmp_path):
    m = gt_model["model_dir"]
    j, t = _both(["model_cropper", "--input_path", m, "--output_path",
                  "crop", "--boundary=-50,-50,-50,0,50,50"], tmp_path)
    assert _files(str(t / "crop")) == _files(str(j / "crop"))
    j, t = _both(["model_splitter", "--input_path", m, "--output_path",
                  "split", "--split_params", "2,1,1"], tmp_path)
    assert _files(str(t / "split")) == _files(str(j / "split"))
    assert len(os.listdir(t / "split")) == 2
    # merge the two halves back (the port's split read by both)
    parts = [str(t / "split" / "0"), str(t / "split" / "1")]
    j, t = _both(["model_merger", "--input_path1", parts[0],
                  "--input_path2", parts[1], "--output_path", "merged"],
                 tmp_path)
    fj, ft = _files(str(j / "merged")), _files(str(t / "merged"))
    for name in ("cameras.bin", "images.bin"):
        assert ft[name] == fj[name], name
    # the merged points pass through the robust Sim3 of the two halves,
    # float32 in both packages in another order (test_torch_model_tools.py)
    rj = jrio.read_model(str(j / "merged"))
    rt = trio.read_model(str(t / "merged"))
    assert set(rt.points3D) == set(rj.points3D)
    assert len(rt.points3D) == len(gt_model["gt"].points3D)
    for pid, p in rj.points3D.items():
        assert sorted(rt.points3D[pid].track) == sorted(p.track)
        np.testing.assert_allclose(rt.points3D[pid].xyz, p.xyz, atol=1e-4)


def test_model_transformer_and_comparer(gt_model, tmp_path, capsys):
    m = gt_model["model_dir"]
    j, t = _both(["model_transformer", "--input_path", m, "--output_path",
                  "tr", "--transform", "2.0,0.9,0.1,0.3,0.2,5,-1,2"],
                 tmp_path)
    rj, rt = jrio.read_model(str(j / "tr")), trio.read_model(str(t / "tr"))
    for iid in rj.images:
        np.testing.assert_allclose(rt.images[iid].cam_from_world,
                                   rj.images[iid].cam_from_world, atol=1e-5)
    for pid in rj.points3D:
        np.testing.assert_allclose(rt.points3D[pid].xyz, rj.points3D[pid].xyz,
                                   rtol=1e-5, atol=1e-5)
    capsys.readouterr()
    outs = []
    for mod, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        assert mod.main(["model_comparer", "--input_path1", str(t / "tr"),
                         "--input_path2", m] + extra) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[1]["num_common_images"] == outs[0]["num_common_images"] == 8
    # float32 arccos of |q.q'| near 1 resolves ~0.01 deg
    assert abs(outs[1]["max_rotation_error_deg"]
               - outs[0]["max_rotation_error_deg"]) <= 0.02
    assert abs(outs[1]["max_proj_center_error"]
               - outs[0]["max_proj_center_error"]) <= 1e-5
    assert outs[1]["max_rotation_error_deg"] < 0.05


def test_model_analyzer_prints_the_same(gt_model, capsys):
    outs = []
    for mod in (jcli, tcli):
        assert mod.main(["model_analyzer", "--path",
                         gt_model["model_dir"]]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert json.loads(outs[1])["num_registered_images"] == 8


def test_point_triangulator_matches_jax(gt_model, tmp_path):
    rec = copy.deepcopy(gt_model["gt"])
    for pid in list(rec.points3D):
        rec.delete_point3D(pid)
    stripped = str(tmp_path / "stripped")
    os.makedirs(stripped)
    trio.write_model(rec, stripped, ext=".bin")
    j, t = _both(["point_triangulator", "--database_path",
                  gt_model["db_path"], "--input_path", stripped,
                  "--output_path", "tri"], tmp_path)
    rj, rt = jrio.read_model(str(j / "tri")), trio.read_model(str(t / "tri"))

    def by_track(r):
        return {tuple(sorted(p.track)): p.xyz for p in r.points3D.values()}

    pj, pt = by_track(rj), by_track(rt)
    assert len(pt) > 100 and len(set(pt) & set(pj)) >= 0.95 * len(pj)
    err = np.array([np.abs(pt[k] - pj[k]).max() for k in set(pt) & set(pj)])
    assert err.max() <= 1e-3, err.max()


# ---------------------------------------------------------------------------
# database commands
# ---------------------------------------------------------------------------


def _rows(path):
    con = sqlite3.connect(path)
    tables = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
    out = {t: con.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall()
           for t in tables}
    out["__schema__"] = con.execute(
        "SELECT type, name, sql FROM sqlite_master ORDER BY name").fetchall()
    con.close()
    return out


def _db_both(tmp_path, src, args, paths=("--database_path",)):
    """Copy `src` to tmp_path/{jax,port}.db, run the command on each copy
    with both CLIs, return both row dumps."""
    dumps = []
    for tag, mod in (("jax", jcli), ("port", tcli)):
        dst = str(tmp_path / f"{tag}.db")
        if src is not None:
            shutil.copy(src, dst)
        argv = []
        for i, a in enumerate(args):
            argv.append(dst if i > 0 and args[i - 1] in paths else a)
        if tag == "port":
            argv += ["--device", "cpu"]
        assert mod.main(argv) == 0
        dumps.append(_rows(dst))
    return dumps


def test_database_creator_and_cleaner(gt_model, tmp_path):
    j, t = _db_both(tmp_path, None, ["database_creator", "--database_path",
                                     "x"])
    assert t == j and t["images"] == []
    for kind in ("matches", "features", "images", "all"):
        (tmp_path / kind).mkdir()
        j, t = _db_both(tmp_path / kind, gt_model["db_path"],
                        ["database_cleaner", "--database_path", "x",
                         "--type", kind])
        assert t == j
    assert t["images"] == [] and t["keypoints"] == []


def test_database_merger(gt_model, tmp_path):
    other = str(tmp_path / "other.db")
    db = Database(other)
    synthetic.synthesize_dataset(synthetic.SyntheticDatasetOptions(
        num_cameras=1, num_images=3, num_points3D=50, seed=9), db)
    db.close()
    dumps = []
    for tag, mod in (("jax", jcli), ("port", tcli)):
        out = str(tmp_path / f"merged_{tag}.db")
        assert mod.main(["database_merger", "--database_path1",
                         gt_model["db_path"], "--database_path2", other,
                         "--merged_database_path", out]) == 0
        dumps.append(_rows(out))
    assert dumps[1] == dumps[0]
    assert len(dumps[1]["images"]) == 11


def test_image_deleter_and_filterer(gt_model, tmp_path):
    j, t = _db_both(tmp_path, gt_model["db_path"],
                    ["image_deleter", "--database_path", "x",
                     "--image_ids", "2,5"])
    assert t == j and len(t["images"]) == 6
    # a second camera with a bogus focal length: its image goes
    bad = str(tmp_path / "bad.db")
    shutil.copy(gt_model["db_path"], bad)
    db = Database(bad)
    cam = db.read_cameras()[1]
    params = np.array(cam["params"], np.float64)
    params[0] *= 50.0
    cid = db.write_camera(cam["model_id"], cam["width"], cam["height"], params)
    db.conn.execute("UPDATE images SET camera_id=? WHERE image_id=3", (cid,))
    db.commit()
    db.close()
    (tmp_path / "f").mkdir()
    j, t = _db_both(tmp_path / "f", bad,
                    ["image_filterer", "--database_path", "x"])
    assert t == j and len(t["images"]) == 7


def test_feature_importer(tmp_path):
    rng = np.random.default_rng(0)
    img_dir, feat_dir = tmp_path / "images", tmp_path / "features"
    img_dir.mkdir()
    feat_dir.mkdir()
    for k in range(3):
        name = f"im{k}.png"
        bitmap.write_bitmap(str(img_dir / name),
                            rng.uniform(0, 1, (48, 64)).astype(np.float32))
        n = 20 + k
        rows = np.concatenate([rng.uniform(0, 60, (n, 2)),
                               rng.uniform(1, 4, (n, 1)),
                               rng.uniform(-3, 3, (n, 1)),
                               rng.integers(0, 256, (n, 128))], 1)
        with open(feat_dir / (name + ".txt"), "w") as fp:
            fp.write(f"{n} 128\n")
            np.savetxt(fp, rows, fmt="%.6f")
    j, t = _db_both(tmp_path, None,
                    ["feature_importer", "--database_path", "x",
                     "--image_path", str(img_dir), "--import_path",
                     str(feat_dir), "--ImageReader.camera_model", "PINHOLE"])
    assert t == j
    assert len(t["images"]) == 3 and len(t["keypoints"]) == 3


def test_matches_importer(gt_model, tmp_path):
    """The synthetic database's descriptors are random, so each track gets
    one descriptor (plus noise per observation) for the re-matching to
    find; its matches and two-view geometries are emptied, then a match
    list of three pairs is imported and verified."""
    rng = np.random.default_rng(1)
    src = str(tmp_path / "src.db")
    shutil.copy(gt_model["db_path"], src)
    db = Database(src)
    desc = {iid: db.read_descriptors(iid) for iid in db.read_images()}
    for p in gt_model["gt"].points3D.values():
        d = rng.integers(20, 236, 128)
        for iid, k in p.track:
            desc[iid][k] = d + rng.integers(-8, 9, 128)
    for iid, d in desc.items():
        db.write_descriptors(iid, d)
    names = {iid: im["name"] for iid, im in db.read_images().items()}
    lines = []
    for a, b in ((1, 2), (2, 3), (1, 4)):
        lines.append(f"{names[a]} {names[b]}")
        lines += [f"{i} {k}" for i, k in db.read_matches(a, b)[:60]]
        lines.append("")
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    db.commit()
    db.close()
    match_list = tmp_path / "matches.txt"
    match_list.write_text("\n".join(lines))
    j, t = _db_both(tmp_path, src,
                    ["matches_importer", "--database_path", "x",
                     "--match_list_path", str(match_list)])
    for table in set(j) - {"two_view_geometries"}:
        assert t[table] == j[table], table
    assert len(t["matches"]) == 3
    tj = {r[0]: r for r in j["two_view_geometries"]}
    tt = {r[0]: r for r in t["two_view_geometries"]}
    assert set(tt) == set(tj) and len(tt) == 3
    for pid in tj:
        assert tt[pid][4] == tj[pid][4]  # config
        mj = {tuple(r) for r in np.frombuffer(
            tj[pid][3], np.uint32).reshape(-1, 2)}
        mt = {tuple(r) for r in np.frombuffer(
            tt[pid][3], np.uint32).reshape(-1, 2)}
        assert len(mj) >= 100
        assert len(mj & mt) >= 0.95 * len(mj | mt)


def test_python_m_help_lists_the_commands():
    res = subprocess.run([sys.executable, "-m", "colmap_tpu_torch", "help"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    listed = {l.strip() for l in res.stdout.splitlines()[1:]}
    assert listed == set(tcli.COMMANDS)
