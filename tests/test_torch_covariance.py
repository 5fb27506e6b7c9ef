"""The port's BA covariances against the JAX package's, on the CPU.

tests/test_estimators_extra.py:84's problem (4 poses, 30 points,
SIMPLE_PINHOLE; gauge: pose 0 frozen and x of pose 1) is handed to both
packages through problem_from_numpy. Both use float32 Jacobians and
accumulate in float64; the gauge-damped reduced system amplifies the
Jacobians' float32 differences, so:
- pose and point covariance blocks: within 2e-3 of the block's largest
  entry of JAX's;
- the full-Hessian reference: 1e-5 of its largest entry;
- the Schur path against the full inverse: rtol 1e-2, atol 1e-8 (the JAX
  test's bound); blocks symmetric positive semi-definite, the frozen pose
  left out.
"""

import numpy as np
import pytest
import torch

from colmap_tpu.estimators import covariance as jcov
from colmap_tpu_torch.estimators import bundle_adjustment as tba
from colmap_tpu_torch.estimators import covariance as tcov
from test_estimators_extra import _small_ba_problem

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def problems():
    jp, model_id = _small_ba_problem(np.random.default_rng(42))
    tp = tba.problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items() if v is not None},
        "cpu")
    return jp, tp, model_id


def _close(a, b, rel):
    np.testing.assert_allclose(a, b, atol=rel * np.abs(b).max())


def test_ba_covariance_matches_jax(problems):
    jp, tp, model_id = problems
    opts = dict(compute_point_covariances=True)
    je = jcov.estimate_ba_covariance(jp, jcov.CovarianceOptions(**opts),
                                     camera_model_id=model_id)
    te = tcov.estimate_ba_covariance(tp, tcov.CovarianceOptions(**opts),
                                     camera_model_id=model_id)
    assert sorted(te.pose_covs) == sorted(je.pose_covs) == [1, 2, 3]
    assert sorted(te.point_covs) == sorted(je.point_covs)
    assert len(te.point_covs) == 30
    for p in je.pose_covs:
        _close(te.pose_covs[p], je.pose_covs[p], 2e-3)
    for m in je.point_covs:
        _close(te.point_covs[m], je.point_covs[m], 2e-3)
    for C in list(te.pose_covs.values()) + list(te.point_covs.values()):
        np.testing.assert_allclose(C, C.T, atol=1e-9 * np.abs(C).max())
        assert np.linalg.eigvalsh(C).min() > -1e-9


def test_full_inverse_matches_jax_and_schur_path(problems):
    jp, tp, model_id = problems
    jf = jcov.estimate_pose_covariance_full_inverse(jp, model_id)
    tf = tcov.estimate_pose_covariance_full_inverse(tp, model_id)
    assert tf.shape == (4, 6, 4, 6)
    _close(tf, jf, 1e-5)
    te = tcov.estimate_ba_covariance(tp, camera_model_id=model_id)
    assert te.point_covs == {}
    for p, C in te.pose_covs.items():
        np.testing.assert_allclose(C, tf[p, :, p, :], rtol=1e-2, atol=1e-8)


def test_ba_covariance_chunks_points(problems, monkeypatch):
    """Chunking the points changes nothing: one point per chunk."""
    _, tp, model_id = problems
    opts = tcov.CovarianceOptions(compute_point_covariances=True)
    whole = tcov.estimate_ba_covariance(tp, opts, camera_model_id=model_id)
    monkeypatch.setattr(tcov, "_CHUNK_ELEMS", 1)
    split = tcov.estimate_ba_covariance(tp, opts, camera_model_id=model_id)
    for p in whole.pose_covs:
        np.testing.assert_allclose(split.pose_covs[p], whole.pose_covs[p],
                                   rtol=1e-9, atol=1e-15)
    for m in whole.point_covs:
        np.testing.assert_allclose(split.point_covs[m], whole.point_covs[m],
                                   rtol=1e-9, atol=1e-15)
