"""The port's multi-device slice (colmap_tpu_torch/parallel/) on the CPU.

The port's shards run on `make_mesh(8, device="cpu")` (eight virtual
shards, one thread each) against the JAX package on its `make_mesh(8)`
(conftest's eight virtual CPU devices), with inputs made from numpy seeds.
Held:
- `pad_to_multiple` equal to JAX's; `resolve_num_devices`; `make_mesh`'s
  round robin over the cards present, at most one shard per card (JAX's
  `jax.devices()[:n]`), its refusal without one, and an explicit `Mesh`
  of virtual shards;
- the collectives: the same bits on every shard, shard order; a shard that
  raises fails the call within seconds;
- sharded and all-gather matching: equal to the port's one-shard run and
  >= 0.999 equal to JAX's (the matcher's tie allowance,
  tests/test_pallas_matcher.py:45);
- `shard_problem_by_pose`: P_local and each shard's observations (order,
  local pose index) equal to JAX's partition;
- `solve_distributed` on 21 poses (pose padding): cost within rtol 1e-3 /
  atol 1e-6 of the port's one-device solve and of JAX's
  `solve_distributed` (tests/test_distributed_ba.py:108), the caller's
  observation arrays and pose count kept; 3 cameras with intrinsics
  refined: cost rtol 5e-2 / atol 1e-4 of the one-device solve, rms < 0.2
  (JAX's bounds); the early exit stops before 30 iterations, every shard
  at the same step with the same `syncs`, each stopping test counted once;
- `match_pairs` on 8 shards against 1, on a synthetic database whose
  tracks share descriptors: matches equal; verification draws differ, so
  verified pairs and, over the pairs both verify, inlier matches each
  >= 95% of their union (PR 9's bar for different draws);
- `IncrementalPipeline` with `mapper.num_devices=8`: JAX's gates 0.5 deg /
  0.05 (tests/test_incremental_pipeline.py:66-82) with >= 1 sharded
  global BA;
- `run_patch_match_stereo(num_devices=2)` on tests/test_torch_dense.py's
  160x120 workspace at 2 iterations: every map written, >= 40% of each
  map estimated, its points a median < 0.03 x room size from the room's
  faces (the smoke's dense depth gates).
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.geometry import rigid3 as jrigid3
from colmap_tpu.parallel import distributed_ba as jdba
from colmap_tpu.parallel import mesh as jmesh
from colmap_tpu.parallel import sharded_matching as jsm
from colmap_tpu_torch.controllers import dense_reconstruction as dense
from colmap_tpu_torch.controllers import feature_matching as fm
from colmap_tpu_torch.controllers.incremental_pipeline import (
    IncrementalPipeline, IncrementalPipelineOptions)
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.estimators.similarity_transform import (
    compare_reconstructions)
from colmap_tpu_torch.mvs import depth_map as dm
from colmap_tpu_torch.mvs import patch_match as pm
from colmap_tpu_torch.parallel import distributed_ba as tdba
from colmap_tpu_torch.parallel import mesh as tmesh
from colmap_tpu_torch.parallel import sharded_matching as tsm
from colmap_tpu_torch.scene.database import Database
from colmap_tpu_torch.scene.synthetic import (SyntheticDatasetOptions,
                                              synthesize_dataset)
from test_bundle_adjustment import build_multi_camera_ba, build_synthetic_ba
from test_torch_dense import _face_distance, workspace  # noqa: F401

torch.set_num_threads(2)

TIE_SHARE = 0.999


@pytest.fixture(scope="module")
def mesh8():
    return tmesh.make_mesh(8, device="cpu")


# ---------------------------------------------------------------------------
# mesh and collectives
# ---------------------------------------------------------------------------


def test_pad_to_multiple_and_resolve_num_devices():
    rng = np.random.default_rng(0)
    for shape, mult, axis, fill in (((13, 3), 8, 0, 0), ((16, 5), 8, 0, 7),
                                    ((3, 10), 4, 1, -1), ((0, 2), 3, 0, 0)):
        x = rng.integers(0, 100, shape)
        np.testing.assert_array_equal(
            tmesh.pad_to_multiple(x, mult, axis, fill),
            jmesh.pad_to_multiple(x, mult, axis, fill))
    assert tmesh.resolve_num_devices(0, "cpu") == 1
    assert tmesh.resolve_num_devices(3, "cpu") == 3
    assert tmesh.resolve_num_devices(-2, "cpu") == 1
    assert tmesh.resolve_num_devices(0, "cuda") == torch.cuda.device_count()
    m = tmesh.make_mesh(8, device="cpu")
    assert m.size == 8 and m.num_distinct == 1 and m.virtual
    assert tmesh.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, device="cpu")


def test_make_mesh_places_shards_round_robin_over_cards(monkeypatch):
    # at most one shard per card present, as JAX's jax.devices()[:n]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = tmesh.make_mesh(5, device="cuda")
    assert [str(d) for d in m.devices] == ["cuda:0", "cuda:1"]
    assert m.num_distinct == 2 and not m.virtual
    assert not tmesh.make_mesh(2, device="cuda").virtual
    assert tmesh.make_mesh(device="cuda").size == 2
    assert [str(d) for d in tmesh.make_mesh(2, device="cuda:1").devices] \
        == ["cuda:1", "cuda:0"]
    assert [str(d) for d in tmesh.make_mesh(5, device="cuda:1").devices] \
        == ["cuda:1", "cuda:0"]
    assert tmesh.shard_mesh(4, "cuda").size == 2
    assert tmesh.shard_mesh(1, "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    m = tmesh.make_mesh(4, device="cuda")
    assert m.size == 1 and [str(d) for d in m.devices] == ["cuda:0"]
    # num_devices=4 on one card takes the callers' one-device path
    assert tmesh.shard_mesh(4, "cuda") is None
    assert tmesh.shard_mesh(0, "cuda") is None
    # the CPU mesh keeps its n shards (JAX's virtual CPU devices)
    assert tmesh.make_mesh(4, device="cpu").size == 4
    assert tmesh.shard_mesh(4, "cpu").size == 4
    # a mesh asked for on the card never lands on the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(4, device="cuda")


def test_explicit_mesh_of_virtual_shards_runs_collectives():
    """Virtual shards, several on one device, are built explicitly."""
    mesh = tmesh.Mesh([torch.device("cpu")] * 4)
    assert mesh.size == 4 and mesh.num_distinct == 1 and mesh.virtual
    out = tmesh.run_shards(mesh, lambda g: g.all_reduce_sum(
        torch.tensor([float(g.rank), 1.0])))
    for t in out:
        assert torch.equal(t, torch.tensor([6.0, 4.0]))


def test_collectives_give_every_shard_the_same_bits(mesh8):
    rng = np.random.default_rng(1)
    xs = [torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
          for _ in range(8)]
    rows = [torch.full((k + 1, 2), k) for k in range(8)]

    def shard(g):
        return (g.all_reduce_sum(xs[g.rank]), g.all_gather(rows[g.rank]),
                g.all_reduce_sum(torch.tensor(float(g.rank))))

    out = tmesh.run_shards(mesh8, shard)
    want = xs[0].clone()
    for x in xs[1:]:
        want += x  # shard order
    for s, gathered, scalar in out:
        assert torch.equal(s, want)
        assert torch.equal(gathered, torch.cat(rows))
        assert float(scalar) == 28.0
    # every shard but the first holds its own copy
    assert len({o[0].data_ptr() for o in out}) == 8


@pytest.mark.parametrize("devices", [["cpu"] * 8, ["cpu", "cpu:0"] * 4])
def test_a_shard_that_raises_fails_the_call(devices):
    """Shards that take turns on one device, and shards on two devices that
    run at once: a shard that raises after two collectives fails the call,
    the others leave their collectives."""
    def shard(g):
        x = torch.ones(4, device=g.device)
        for k in range(1000):  # the others wait in collectives: no end
            if g.rank == 3 and k == 2:
                raise ValueError("shard 3 failed")
            x = g.all_reduce_sum(x) / 8

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 3 failed"):
        tmesh.run_shards(tmesh.Mesh(devices), shard)
    assert time.perf_counter() - t0 < 10.0
    assert not any(t.name.startswith("shard-") for t in threading.enumerate())


# ---------------------------------------------------------------------------
# sharded matching
# ---------------------------------------------------------------------------


def _desc_pairs(rng, B, N):
    """tests/test_util_parallel.py's pairs: side 2 is a noisy permutation
    of side 1."""
    d1 = rng.integers(0, 200, (B, N, 128)).astype(np.uint8)
    perms = [rng.permutation(N) for _ in range(B)]
    d2 = np.stack([np.clip(d1[b][perms[b]].astype(int)
                           + rng.integers(-3, 4, (N, 128)), 0, 255)
                   for b in range(B)]).astype(np.uint8)
    return d1, d2, np.ones((B, N), bool), perms


@pytest.mark.parametrize("N", [128, 100])
def test_sharded_pair_matching_matches_one_shard_and_jax(mesh8, N):
    rng = np.random.default_rng(N)
    d1, d2, v, perms = _desc_pairs(rng, 8, N)
    v2 = v.copy()
    v2[5, N // 2:] = False  # a partly padded pair
    out = tsm.match_pair_blocks_sharded(mesh8, d1, d2, v, v2)
    assert out.shape == (8, N) and out.dtype == np.int32
    one = tsm.match_pair_blocks_sharded(tmesh.make_mesh(1, device="cpu"),
                                        d1, d2, v, v2)
    np.testing.assert_array_equal(out, one)
    ref = jsm.match_pair_blocks_sharded(jmesh.make_mesh(8), d1, d2, v, v2)
    assert (out == ref).mean() >= TIE_SHARE
    m = out[0] >= 0
    assert m.mean() > 0.9
    assert (out[0][m] == np.argsort(perms[0])[m]).mean() > 0.99
    with pytest.raises(ValueError, match="multiple of 8"):
        tsm.match_pair_blocks_sharded(mesh8, d1[:6], d2[:6], v[:6], v2[:6])


def test_all_gather_matching_matches_one_shard_and_jax(mesh8):
    rng = np.random.default_rng(2)
    I, N = 8, 64
    base = rng.integers(0, 200, (N, 128)).astype(np.uint8)
    descs = np.stack([
        np.clip(base.astype(int) + rng.integers(-3, 4, (N, 128)), 0, 255)
        for _ in range(I)]).astype(np.uint8)
    valid = np.ones((I, N), bool)
    out = tsm.exhaustive_match_all_gather(mesh8, descs, valid)
    assert out.shape == (I, I, N)
    one = tsm.exhaustive_match_all_gather(tmesh.make_mesh(1, device="cpu"),
                                          descs, valid)
    np.testing.assert_array_equal(out, one)
    ref = jsm.exhaustive_match_all_gather(jmesh.make_mesh(8), descs, valid)
    assert (out == ref).mean() >= TIE_SHARE
    assert (out[0, 1] == np.arange(N)).mean() > 0.9


# ---------------------------------------------------------------------------
# distributed bundle adjustment
# ---------------------------------------------------------------------------


def _problems(num_poses, num_points, sigma, seed, multi_camera=False):
    """A JAX problem (segment-sum path) and the port's copy of it."""
    rng = np.random.default_rng(seed)
    if multi_camera:
        poses, cams, points, obs, model_id = build_multi_camera_ba(
            rng, num_poses=num_poses, num_cams=3, num_points=num_points)
        op, oc, opt_, oxy = obs
        n = (len(op) // 8) * 8 - 3  # not a multiple of the shard count
        obs = (op[:n], oc[:n], opt_[:n], oxy[:n])
    else:
        poses, cams, points, obs, model_id = build_synthetic_ba(
            rng, num_poses=num_poses, num_points=num_points)
    noisy = np.array(jrigid3.exp_update(
        jnp.asarray(poses),
        jnp.asarray(rng.normal(0, sigma, (len(poses), 6)).astype(np.float32))))
    noisy[0], noisy[1] = poses[0], poses[1]
    kw = (dict(refine_intrinsics=True, camera_model_ids=[model_id] * len(cams))
          if multi_camera else {})
    jp = jba.make_problem(noisy, cams, points, *obs,
                          fix_first_pose_and_gauge=True, **kw)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()
              if v is not None}
    return jp, tba.problem_from_numpy(fields, "cpu"), model_id


def _rms(problem, options):
    cost = float(tba.compute_cost(problem, options))
    return np.sqrt(2 * cost / float(problem.obs_weight.sum()))


def test_shard_problem_by_pose_matches_jax():
    jp, tp, _ = _problems(21, 200, 0.006, seed=5)
    parts = tdba.shard_problem_by_pose(tp, 8)
    jsharded, P_local, N_shard, _, _ = jdba.shard_problem_by_pose(jp, 8)
    assert parts.P_local == P_local == 3
    pose = np.asarray(jp.obs_pose_idx)
    np.testing.assert_array_equal(parts.obs_shard.numpy(), pose // P_local)
    np.testing.assert_array_equal(parts.obs_local_pose.numpy(),
                                  pose % P_local)
    jw = np.asarray(jsharded.obs_weight)
    for k, shard in enumerate(parts.shards):
        sl = slice(k * N_shard, (k + 1) * N_shard)
        n = len(shard.obs_xy)
        assert n == int((pose // P_local == k).sum())
        # JAX's slice holds the same observations first, then weight-0 pads
        for name in ("obs_pose_idx", "obs_cam_idx", "obs_point_idx",
                     "obs_xy"):
            np.testing.assert_array_equal(
                getattr(shard, name).numpy(),
                np.asarray(getattr(jsharded, name))[sl][:n], err_msg=name)
        assert not jw[sl][n:].any()
        np.testing.assert_array_equal(
            shard.poses.numpy(), np.asarray(jsharded.poses)[
                k * P_local:(k + 1) * P_local])
    # the padded poses are frozen identities
    pad = parts.shards[-1]
    np.testing.assert_array_equal(pad.poses[-3:].numpy(),
                                  np.tile([1, 0, 0, 0, 0, 0, 0], (3, 1)))
    assert not pad.pose_mask[-3:].any()


def test_solve_distributed_matches_single_and_jax(mesh8):
    jp, tp, model_id = _problems(21, 200, 0.006, seed=6)
    opts = dict(max_iterations=15, cg_iterations=25, camera_model_id=model_id,
                function_tolerance=0.0, cg_tolerance=0.0)
    topts = tba.BAOptions(**opts)
    state = tdba.solve_distributed(tp, topts, mesh8)
    single = tba.solve(tp, topts)
    np.testing.assert_allclose(float(state.cost), float(single.cost),
                               rtol=1e-3, atol=1e-6)
    jstate = jdba.solve_distributed(jp, jba.BAOptions(**opts),
                                    jmesh.make_mesh(8))
    np.testing.assert_allclose(float(state.cost), float(jstate.cost),
                               rtol=1e-3, atol=1e-6)
    # the caller's contract: pose count, observation arrays and masks
    assert state.problem.poses.shape == tp.poses.shape
    for name in ("obs_pose_idx", "obs_cam_idx", "obs_point_idx", "obs_xy",
                 "obs_weight", "pose_mask"):
        assert torch.equal(getattr(state.problem, name), getattr(tp, name))
    assert state.iteration == 15 and state.cg_steps == 15 * 25
    assert _rms(state.problem, topts) < 0.1
    # frozen poses stay put
    np.testing.assert_array_equal(state.problem.poses[0].numpy(),
                                  tp.poses[0].numpy())


def test_solve_distributed_multi_camera_uneven_shards(mesh8):
    _, tp, model_id = _problems(24, 150, 0.004, seed=7, multi_camera=True)
    topts = tba.BAOptions(max_iterations=12, cg_iterations=25,
                          camera_model_id=model_id)
    state = tdba.solve_distributed(tp, topts, mesh8)
    single = tba.solve(tp, topts)
    np.testing.assert_allclose(float(state.cost), float(single.cost),
                               rtol=5e-2, atol=1e-4)
    assert _rms(state.problem, topts) < 0.2
    assert not torch.equal(state.problem.cam_params, tp.cam_params)


def test_solve_distributed_early_exit(mesh8):
    # JAX's case (no pose noise: it stops before a step) and a noisy one
    # that stops after a few LM steps, each with CG stopping early
    for sigma, steps in ((0.0, 0), (0.004, 5)):
        _, tp, model_id = _problems(6, 80, sigma, seed=8)
        topts = tba.BAOptions(max_iterations=30, cg_iterations=10,
                              camera_model_id=model_id,
                              function_tolerance=1e-6)
        state = tdba.solve_distributed(tp, topts, mesh8)
        assert state.iteration == steps < 30
        # every shard stops at the same LM and CG steps and counts each
        # stopping test once: one LM test per step plus the one that
        # stopped the loop, and per LM step one CG test per CG step plus
        # one more where CG stopped early (between 0 and `iteration` more)
        parts = tdba.shard_problem_by_pose(tp, 8)
        states = tmesh.run_shards(mesh8, lambda g: tba.run_lm(
            tba.init_state(parts.shards[g.rank], topts, g), topts, g))
        counts = {(s.iteration, s.cg_steps, s.syncs) for s in states}
        assert counts == {(state.iteration, state.cg_steps, state.syncs)}
        lm_tests = state.iteration + 1
        assert lm_tests + state.cg_steps <= state.syncs \
            <= lm_tests + state.cg_steps + state.iteration
        single = tba.solve(tp, topts)
        assert tdba.solve_distributed(
            tp, topts, tmesh.make_mesh(1, "cpu")).iteration \
            == single.iteration


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------


def _match(num_devices, guided, block_pairs):
    """match_pairs on synthesize_dataset(num_images=9, seed=4) with
    descriptors that match: the generator's are random, so each track's
    keypoints get one base descriptor plus +-3 levels of noise."""
    db = Database(":memory:")
    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_images=9, num_points3D=120, point2D_stddev=0.2, seed=4), db)
    rng = np.random.default_rng(9)
    desc = {iid: db.read_descriptors(iid).astype(np.int64)
            for iid in gt.images}
    for pt in gt.points3D.values():
        base = rng.integers(0, 200, 128)
        for iid, k in pt.track:
            desc[iid][k] = base + rng.integers(-3, 4, 128)
    for iid, d in desc.items():
        db.write_descriptors(iid, np.clip(d, 0, 255).astype(np.uint8))
    ids = sorted(db.read_images().keys())
    pairs = [(ids[i], ids[j]) for i in range(len(ids))
             for j in range(i + 1, len(ids))][:16]
    db.conn.execute("DELETE FROM matches")
    db.conn.execute("DELETE FROM two_view_geometries")
    opts = fm.FeatureMatchingOptions(num_devices=num_devices,
                                     feature_capacity=256,
                                     block_pairs=block_pairs,
                                     guided_matching=guided)
    stats = fm.match_pairs(db, pairs, opts, seed=7, device="cpu")
    matches = {p: db.read_matches(*p) for p in pairs}
    tvgs = {k: db.read_two_view_geometry(*k)["inlier_matches"]
            for k in db.read_all_two_view_geometries()}
    db.close()
    return stats, matches, tvgs


@pytest.mark.parametrize("guided,block_pairs", [(False, 16), (True, 5)])
def test_match_pairs_on_eight_shards_matches_one(guided, block_pairs):
    """block_pairs=5 leaves shards without pairs in every block."""
    s1, m1, t1 = _match(1, guided, block_pairs)
    s8, m8, t8 = _match(8, guided, block_pairs)
    assert s8.num_pairs == s1.num_pairs == 16
    assert s8.num_blocks == s1.num_blocks
    assert s8.num_matched_pairs == s1.num_matched_pairs > 0
    for p in m1:
        if m1[p] is None:
            assert m8[p] is None
        else:
            np.testing.assert_array_equal(m8[p], m1[p])
    both = set(t1) & set(t8)
    assert len(both) >= 0.95 * len(set(t1) | set(t8)) and both
    common = union = 0
    for k in both:
        a = {tuple(r) for r in t1[k]}
        b = {tuple(r) for r in t8[k]}
        common += len(a & b)
        union += len(a | b)
    assert common >= 0.95 * union


def test_pipeline_on_eight_shards_passes_the_jax_gates():
    db = Database(":memory:")
    gt = synthesize_dataset(SyntheticDatasetOptions(
        num_images=10, num_points3D=150, point2D_stddev=0.3), db)
    opts = IncrementalPipelineOptions()
    opts.mapper.num_devices = 8
    pipe = IncrementalPipeline(db, opts, device="cpu")
    rec = pipe.run()
    db.close()
    assert rec is not None and rec.num_registered_images() == 10
    cmp = compare_reconstructions(rec, gt, device="cpu")
    assert cmp["max_rotation_error_deg"] < 0.5, cmp["rotation_errors_deg"]
    assert cmp["max_center_error"] < 0.05, cmp["center_errors"]
    assert pipe.ba_stats["gba_sharded_calls"] >= 1
    assert pipe.ba_stats["gba_calls"] >= pipe.ba_stats["gba_sharded_calls"]


def test_patch_match_round_robin_on_two_shards(workspace):  # noqa: F811
    ws, o = workspace
    timings = {}
    depths = dense.run_patch_match_stereo(
        ws, dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=2,
                                             num_refinement_iterations=1),
            max_num_src_images=3, geom_consistency=True, num_devices=2),
        device="cpu", timings=timings)
    assert sorted(depths) == [1, 2, 3, 4] and timings["maps"] == 4
    from colmap_tpu_torch.mvs import model as model_mod
    from colmap_tpu_torch.scene import reconstruction_io
    model = model_mod.build_model(
        reconstruction_io.read_model(os.path.join(ws, "sparse")))
    s = o.room_size
    for iid, im in model.images.items():
        path = os.path.join(ws, "stereo", "depth_maps",
                            f"{im.name}.geometric.bin")
        depth = dm.DepthMap.read(path).data
        np.testing.assert_array_equal(depth, depths[iid])
        assert os.path.exists(os.path.join(
            ws, "stereo", "normal_maps", f"{im.name}.geometric.bin"))
        ys, xs = np.nonzero(depth > 0)
        assert len(ys) >= 0.4 * depth.size, len(ys) / depth.size
        rays = np.linalg.inv(im.K) @ np.stack(
            [xs + 0.5, ys + 0.5, np.ones_like(xs, dtype=float)])
        X = im.R.T @ (rays * depth[ys, xs] - im.t[:, None])
        assert np.median(_face_distance(X.T, s)) < 0.03 * s


def test_patch_match_stereo_cli_on_two_shards(workspace):  # noqa: F811
    """`patch_match_stereo --num_devices 2` runs (photometric, then
    geometric) and writes every map."""
    from colmap_tpu_torch import cli

    ws, _ = workspace
    assert cli.main(["patch_match_stereo", "--workspace_path", ws,
                     "--num_devices", "2", "--device", "cpu",
                     "--PatchMatchStereo.num_iterations", "1",
                     "--PatchMatchStereo.num_refinement_iterations", "0"]) == 0
    for i in range(4):
        path = os.path.join(ws, "stereo", "depth_maps",
                            f"image{i:04d}.png.geometric.bin")
        assert (dm.DepthMap.read(path).data > 0).mean() > 0.2
