"""The port's bundle adjustment against the JAX package's, on the CPU.

One problem from the JAX test generator (tests/test_bundle_adjustment.py:
8 poses on a circle, 200 points, SIMPLE_RADIAL) is built by the JAX
package's make_problem(skip_layouts=True), so the JAX solver takes its
segment-sum path, the one the port has, and handed to the port through
problem_from_numpy. Tolerances (float32 on both sides; the two sum in
another order):
- residuals: 1e-3 px abs; Jacobians: 1e-3 abs + 1e-4 rel;
- one LM step: cost 1e-4 rel, poses 1e-5 abs, points 1e-5 abs;
- a full cauchy solve: final cost 1e-3 rel, poses 1e-4 abs;
- truncated CG: the port stops within one iteration of where JAX does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import bundle_adjustment as jba
from colmap_tpu.geometry import rigid3 as jrigid3
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from test_bundle_adjustment import build_synthetic_ba

torch.set_num_threads(2)

JAC_ATOL, JAC_RTOL = 1e-3, 1e-4


def _problems(seed=3, noise_px=0.0, refine_intrinsics=False, pose_sigma=0.01,
              point_sigma=0.02):
    rng = np.random.default_rng(seed)
    poses, cams, points, obs, model_id = build_synthetic_ba(
        rng, noise_px=noise_px)
    noisy_poses = np.array(jrigid3.exp_update(
        jnp.asarray(poses),
        jnp.asarray(rng.normal(0, pose_sigma, (len(poses), 6))
                    .astype(np.float32))))
    noisy_poses[0], noisy_poses[1] = poses[0], poses[1]
    noisy_points = points + rng.normal(0, point_sigma, points.shape).astype(
        np.float32)
    jp = jba.make_problem(noisy_poses, cams, noisy_points, *obs,
                          fix_first_pose_and_gauge=True,
                          refine_intrinsics=refine_intrinsics,
                          camera_model_ids=[model_id], skip_layouts=True)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()
              if v is not None}
    return jp, tba.problem_from_numpy(fields, "cpu"), model_id, poses


@pytest.mark.parametrize("with_cam", [True, False])
def test_residuals_and_jacobians_match_jax(with_cam):
    jp, tp, model_id, _ = _problems()
    j = jba._obs_residual_and_jac(jp, model_id, with_cam=with_cam)
    t = tba._obs_residual_and_jac(tp, model_id, with_cam=with_cam)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=1e-3)
    for name, a, b in zip(("Jp", "Jc", "Jx"), t[1:], j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=JAC_ATOL,
                                   rtol=JAC_RTOL, err_msg=name)
    if not with_cam:
        assert not t[2].any()


def test_lm_step_matches_jax():
    jp, tp, model_id, _ = _problems(refine_intrinsics=True)
    opts = jba.BAOptions(cg_iterations=20, camera_model_id=model_id,
                         loss="cauchy", loss_scale=2.0)
    topts = tba.BAOptions(cg_iterations=20, camera_model_id=model_id,
                          loss="cauchy", loss_scale=2.0)
    js = jax.jit(lambda p: jba.lm_step(jba.init_state(p, opts), opts))(jp)
    ts = tba.lm_step(tba.init_state(tp, topts), topts)
    assert float(ts.cost) < float(tba.compute_cost(tp, topts))  # accepted
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-4)
    np.testing.assert_allclose(ts.problem.poses.numpy(),
                               np.asarray(js.problem.poses), atol=1e-5)
    np.testing.assert_allclose(ts.problem.points.numpy(),
                               np.asarray(js.problem.points), atol=1e-5)
    np.testing.assert_allclose(ts.problem.cam_params.numpy(),
                               np.asarray(js.problem.cam_params), rtol=1e-5)
    assert ts.iteration == 1 and ts.cg_steps >= 1


def test_lm_step_without_intrinsics_matches_jax():
    """Without intrinsics the port skips every camera term; JAX's
    segment-sum path carries them as zeros. The steps agree."""
    jp, tp, model_id, _ = _problems()
    kw = dict(cg_iterations=20, camera_model_id=model_id, loss="cauchy",
              loss_scale=2.0, refine_intrinsics=False)
    opts, topts = jba.BAOptions(**kw), tba.BAOptions(**kw)
    js = jax.jit(lambda p: jba.lm_step(jba.init_state(p, opts), opts))(jp)
    ts = tba.lm_step(tba.init_state(tp, topts), topts)
    assert float(ts.cost) < float(tba.compute_cost(tp, topts))  # accepted
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-4)
    np.testing.assert_allclose(ts.problem.poses.numpy(),
                               np.asarray(js.problem.poses), atol=1e-5)
    np.testing.assert_allclose(ts.problem.points.numpy(),
                               np.asarray(js.problem.points), atol=1e-5)
    assert torch.equal(ts.problem.cam_params, tp.cam_params)


def test_solve_cauchy_matches_jax():
    jp, tp, model_id, truth = _problems(noise_px=0.5)
    kw = dict(max_iterations=25, cg_iterations=25, loss="cauchy",
              loss_scale=2.0, camera_model_id=model_id)
    js = jba.solve(jp, jba.BAOptions(**kw))
    ts = tba.solve(tp, tba.BAOptions(**kw))
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-3)
    np.testing.assert_allclose(ts.problem.poses.numpy(),
                               np.asarray(js.problem.poses), atol=1e-4)
    # converged to the noise floor, near the truth
    n = float(tp.obs_weight.sum())
    assert np.sqrt(2 * float(ts.cost) / n) < 0.8
    assert np.abs(ts.problem.poses.numpy()[:, 4:] - truth[:, 4:]).max() < 0.02
    # the stopping tests were read on the host, and counted
    assert 0 < ts.iteration <= 25 and ts.syncs >= ts.iteration


def test_frozen_dofs_stay_and_intrinsics_refine():
    rng = np.random.default_rng(4)
    poses, cams, points, obs, model_id = build_synthetic_ba(rng)
    bad = cams.copy()
    bad[0, 0] *= 1.02  # 2% focal error
    tp = tba.make_problem(poses, bad, points, *obs,
                          fix_first_pose_and_gauge=True,
                          refine_intrinsics=True, device="cpu")
    tp = tp._replace(point_mask=torch.zeros_like(tp.point_mask))
    state = tba.solve(tp, tba.BAOptions(max_iterations=30, cg_iterations=40,
                                        camera_model_id=model_id))
    out = state.problem
    assert torch.equal(out.points, tp.points)
    assert torch.equal(out.poses[0], tp.poses[0])
    assert float(out.poses[1, 4]) == float(tp.poses[1, 4])
    assert abs(float(out.cam_params[0, 0]) - 1000.0) < 5.0
    # principal point held, the distortion parameter free
    assert torch.equal(out.cam_params[0, 1:3], tp.cam_params[0, 1:3])


def test_truncated_cg_stops_where_jax_does():
    jp, tp, model_id, _ = _problems(pose_sigma=0.003, point_sigma=0.005)
    trunc = dict(max_iterations=1, cg_iterations=25, camera_model_id=model_id,
                 cg_tolerance=0.1)
    ts = tba.lm_step(tba.init_state(tp, tba.BAOptions(**trunc)),
                     tba.BAOptions(**trunc))
    # JAX's while_loop does not report its trip count: find the fixed trip
    # count whose step comes closest to its truncated one
    fixed = jba.BAOptions(**dict(trunc, cg_tolerance=0.0))
    jt = jax.jit(lambda p: jba.lm_step(jba.init_state(p, jba.BAOptions(
        **trunc)), jba.BAOptions(**trunc)))(jp)
    step = jax.jit(lambda p, n: jba.lm_step(jba.init_state(p, fixed), fixed,
                                            cg_iters=n))
    ref = np.asarray(jt.problem.poses)
    diffs = [np.abs(np.asarray(step(jp, jnp.int32(n)).problem.poses)
                    - ref).max() for n in range(1, 26)]
    jax_trips = 1 + int(np.argmin(diffs))
    assert diffs[jax_trips - 1] < 1e-6, diffs
    assert 1 <= ts.cg_steps < 25
    assert abs(ts.cg_steps - jax_trips) <= 1, (ts.cg_steps, jax_trips)
    assert ts.syncs == ts.cg_steps + 1  # one test per trip, one to stop


def test_inv3x3_sym_and_segsum():
    g = torch.Generator().manual_seed(0)
    A = torch.randn(50, 3, 3, generator=g, dtype=torch.float64)
    A = A @ A.transpose(-1, -2) + torch.eye(3, dtype=torch.float64)
    torch.testing.assert_close(tba._inv3x3_sym(A), torch.linalg.inv(A))
    x = torch.randn(40, 2, generator=g)
    idx = torch.randint(0, 7, (40,), generator=g)
    ref = torch.stack([x[idx == k].sum(0) for k in range(7)])
    torch.testing.assert_close(tba._segsum(x, idx, 7), ref)


def test_bench_problem_matches_jax_bench():
    """bench_ba.build_problem draws the same problem as the JAX package's
    __graft_entry__._build_problem (the BA cell of bench.py)."""
    cache_dir = jax.config.jax_compilation_cache_dir
    import __graft_entry__
    # importing it points JAX's compile cache elsewhere: point it back
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    from colmap_tpu_torch import bench_ba

    jp, jopts = __graft_entry__._build_problem(num_poses=12, num_points=300,
                                               obs_per_point=3, seed=5)
    tp, topts = bench_ba.build_problem(num_poses=12, num_points=300,
                                       obs_per_point=3, seed=5, device="cpu")
    for name in tba.BAProblem._fields:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        if name.endswith("_idx") or name.endswith("mask") or name == "obs_weight":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-5,
                                       err_msg=name)
    assert (topts.max_iterations, topts.cg_iterations) == (
        jopts.max_iterations, jopts.cg_iterations)
    # one solve's CG reads 20 x 10 matvecs of 72 bytes per observation
    opts = tba.BAOptions(max_iterations=10, cg_iterations=20,
                         refine_intrinsics=False)
    n = tp.obs_xy.shape[0]
    assert bench_ba.cg_bytes_bound_ms(tp, opts) == pytest.approx(
        200 * n * 72 / 3.35e12 * 1e3)
