"""The port's full_scale_run and benchmark_reconstruction against the JAX
package's scripts on the CPU (scale_run and scaling_curve are in
test_torch_scripts.py, which holds the helpers).

Held:
- full_scale_run at 16 frames of the 320x240 orbit, the cheapest depth at
  which both packages build a model (at 6 and 12 frames no pair passes
  the initial pair's gates): the frames each package renders within one
  level of each other's PNG, the ground-truth models equal to 1e-6, the
  same exit code (1: the 95% registration gate fails), the port's report
  with the JAX report's keys plus `device` and `k1_launches`; the same
  registered count, the largest rotation error within 0.3 deg of JAX's
  and the largest centre error within 0.003 of JAX's (the readings are
  beside FULL_TOL); a second port run reuses the cached frames;
- benchmark_reconstruction --synthetic 6 at the script's 320x240: the
  same exit code, report keys, registered count and gate result in both,
  the largest rotation error within 0.1 deg of JAX's and the largest
  centre error within 0.001 of JAX's; the port's --dataset_path route on
  that render laid out as ETH3D held to JAX's run by the same
  tolerances; a missing ground truth exits 2 in both.
"""

import os
import shutil

import numpy as np
import torch

from colmap_tpu_torch.geometry import rotation as rot
from colmap_tpu_torch.scene import reconstruction_io as rio
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.reconstruction import (Camera, Image,
                                                   Reconstruction)
from colmap_tpu_torch.scripts import benchmark_reconstruction as tbench
from colmap_tpu_torch.scripts import full_scale_run as tfull
from colmap_tpu_torch.sensor import bitmap
from test_torch_scripts import PORT_KEYS, _last_json, _read, _run_jax

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# full_scale_run
# ---------------------------------------------------------------------------


FULL_FRAMES = 16
# |port - JAX| allowed for the largest rotation (deg) and centre error of
# a model. The mappers' draws differ, so the errors differ: JAX 0.6342 deg
# / 0.01032, the port 0.8729 / 0.0092 at 16 frames; JAX 1.2672 / 0.01552,
# the port 1.2994 / 0.01542 at --synthetic 6 by both routes (1.2987 deg
# in another run)
FULL_TOL = (0.3, 0.003)
BENCH_TOL = (0.1, 0.001)


def _errors_held(trep, jrep, tol):
    rot_tol, centre_tol = tol
    assert abs(trep["max_rotation_error_deg"]
               - jrep["max_rotation_error_deg"]) <= rot_tol, (trep, jrep)
    assert abs(trep["max_center_error"]
               - jrep["max_center_error"]) <= centre_tol, (trep, jrep)


def test_full_scale_run_matches_jax(tmp_path, monkeypatch):
    args = ["--num_images", str(FULL_FRAMES), "--width", "320",
            "--height", "240"]
    rc_j = _run_jax(monkeypatch, "full_scale_run", args + [
        "--workspace", str(tmp_path / "jax")])
    rc_t = tfull.main(args + ["--workspace", str(tmp_path / "port"),
                              "--device", "cpu"])
    jrep = _read(tmp_path / "jax" / "report.json")
    trep = _read(tmp_path / "port" / "report.json")
    # both build a model that misses the 95% registration gate
    assert rc_j == rc_t == 1
    assert jrep["ok"] is trep["ok"] is False
    assert "reason" not in jrep and "reason" not in trep
    assert set(trep) - set(jrep) == PORT_KEYS["full_scale_run"]
    assert set(jrep) <= set(trep)
    for k in ("num_images", "resolution", "pipeline"):
        assert trep[k] == jrep[k], k
    assert 2 <= trep["num_registered"] == jrep["num_registered"] \
        < 0.95 * FULL_FRAMES
    assert trep["num_points3D"] > 0
    _errors_held(trep, jrep, FULL_TOL)
    assert {"extraction", "matching", "mapping"} <= \
        set(trep["stage_seconds"])
    assert trep["stage_seconds"]["matching_stats"]["num_blocks"] >= 1
    assert trep["k1_launches"] == 0  # the plain twin runs on the CPU

    # the same frames and the same ground truth
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images"))
    assert len(names) == FULL_FRAMES
    for nm in names:
        a = bitmap.read_bitmap(str(tmp_path / "jax" / "images" / nm)).data
        b = bitmap.read_bitmap(str(tmp_path / "port" / "images" / nm)).data
        # read back as gray float32 in [0, 1]: one PNG level is 1 / 255
        assert a.shape == b.shape == (240, 320)
        assert a.std() > 0.05, nm
        levels = np.abs(a.astype(np.float64) - b.astype(np.float64)) * 255
        assert levels.max() <= 1.0 + 1e-6, nm
    gj = rio.read_model(tmp_path / "jax" / "gt_model")
    gt = rio.read_model(tmp_path / "port" / "gt_model")
    assert sorted(gj.images) == sorted(gt.images) == \
        list(range(1, FULL_FRAMES + 1))
    np.testing.assert_allclose(gt.cameras[1].params, gj.cameras[1].params)
    for i in gt.images:
        assert gt.images[i].name == gj.images[i].name
        np.testing.assert_allclose(gt.images[i].cam_from_world,
                                   gj.images[i].cam_from_world, atol=1e-6)

    # a second run reuses the cached frames and ground truth
    rc = tfull.main(args + ["--workspace", str(tmp_path / "port"),
                            "--device", "cpu"])
    again = _read(tmp_path / "port" / "report.json")
    assert rc == 1
    assert again["render_s"] <= trep["render_s"]
    assert again["num_registered"] == trep["num_registered"]


# ---------------------------------------------------------------------------
# benchmark_reconstruction
# ---------------------------------------------------------------------------


BENCH_IMAGES = 6


def test_benchmark_reconstruction_matches_jax(tmp_path, monkeypatch,
                                              capsys):
    args = ["--synthetic", str(BENCH_IMAGES)]
    rc_j = _run_jax(monkeypatch, "benchmark_reconstruction", args + [
        "--workspace", str(tmp_path / "jax"),
        "--report_path", str(tmp_path / "jax.json")])
    jrep = _last_json(capsys.readouterr().out)
    rc_t = tbench.main(args + ["--workspace", str(tmp_path / "port"),
                               "--report_path", str(tmp_path / "port.json"),
                               "--device", "cpu"])
    trep = _last_json(capsys.readouterr().out)
    # at 320x240 both register every image and both miss the rotation
    # gate: the same gate result, the same exit code
    assert rc_j == rc_t
    assert set(trep) - set(jrep) == PORT_KEYS["benchmark_reconstruction"]
    assert set(jrep) <= set(trep)
    assert trep["ok"] is jrep["ok"]
    assert rc_t == (0 if trep["ok"] else 1)
    for k in ("num_registered", "num_gt_images"):
        assert trep[k] == jrep[k] == BENCH_IMAGES, k
    _errors_held(trep, jrep, BENCH_TOL)
    assert trep["stage_seconds"]["matching_stats"]["num_blocks"] == 1

    # the port's --dataset_path route on the same render, laid out as
    # ETH3D (images/ and the ground truth as a text model)
    data = tmp_path / "eth3d"
    shutil.copytree(tmp_path / "port" / "images", data / "images")
    o = synth.RoomDatasetOptions(num_images=BENCH_IMAGES, width=320,
                                 height=240, focal=0.875 * 320, seed=11,
                                 texture_res=512)
    _, K, Rs, ts = synth.render_room_dataset(o)
    gt = Reconstruction()
    gt.add_camera(Camera(camera_id=1, model_id=1, width=320, height=240,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                          K[1, 2]])))
    names = sorted(os.listdir(data / "images"))
    for i, (R, t) in enumerate(zip(Rs, ts)):
        q = rot.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        gt.add_image(Image(image_id=i + 1, name=names[i], camera_id=1,
                           cam_from_world=np.concatenate([q.numpy(), t])))
    rio.write_model(gt, data / "dslr_calibration_undistorted", ext=".txt")
    rc_d = tbench.main(["--dataset_path", str(data), "--device", "cpu",
                        "--report_path", str(tmp_path / "eth3d.json")])
    drep = _read(tmp_path / "eth3d.json")
    assert _last_json(capsys.readouterr().out) == drep
    assert rc_d == rc_t
    assert drep["ok"] is trep["ok"]
    assert drep["num_registered"] == drep["num_gt_images"] == BENCH_IMAGES
    _errors_held(drep, jrep, BENCH_TOL)
    assert os.path.isdir(data / "ws_tpu" / "sparse")


def test_benchmark_reconstruction_missing_gt_exits_2(tmp_path, monkeypatch,
                                                     capsys):
    (tmp_path / "images").mkdir()
    args = ["--dataset_path", str(tmp_path)]
    assert _run_jax(monkeypatch, "benchmark_reconstruction", args) == 2
    assert tbench.main(args + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.count("ground-truth model not found") == 2


