"""Card-only checks of the port: the matcher kernel against its plain twin
at edge cases, and the front end on CUDA against the same front end on the
CPU. Every test needs a CUDA device and the CUDA toolkit and skips without
them. This file imports neither jax nor colmap_tpu, so it also runs on a
machine without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from colmap_tpu_torch.controllers import automatic_reconstruction as ar
from colmap_tpu_torch.features import hopper_matcher as hm
from colmap_tpu_torch.features import matching as tm
from colmap_tpu_torch.scene import synthetic_images as synth
from colmap_tpu_torch.scene.database import Database

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the matcher kernel has no CPU mode")
    return "cuda"


def _blocks(rng, B, n, m, device, dup=False):
    d1 = rng.integers(0, 200, (B, n, 128)).astype(np.uint8)
    d2 = rng.integers(0, 200, (B, m, 128)).astype(np.uint8)
    k = min(n, m)
    d2[:, :k] = np.clip(d1[:, :k].astype(int)
                        + rng.integers(-3, 4, (B, k, 128)), 0, 255)
    if dup:  # exact ties: repeated target rows and repeated query rows
        d2[:, 1::2] = d2[:, 0::2][:, : d2[:, 1::2].shape[1]]
        d1[:, 1::2] = d1[:, 0::2][:, : d1[:, 1::2].shape[1]]
    v1 = rng.random((B, n)) > 0.1
    v2 = rng.random((B, m)) > 0.1
    v2[0] = False  # a pair whose targets are all padding
    return (tm.prepare_descriptors(d1, v1, device=device),
            tm.prepare_descriptors(d2, v2, device=device))


def _assert_kernel_equals_twin(b1, b2):
    before = hm.launches
    k = hm.top2_fwd_rev(b1, b2)
    assert hm.launches > before
    r = hm._top2_fwd_rev_reference(b1, b2)
    for name, a, b in zip(("best", "second", "idx", "rbest", "ridx"), k, r):
        assert torch.equal(a, b), name
    return k


@pytest.mark.parametrize("n,m,dup", [(64, 64, False), (256, 512, False),
                                     (512, 192, True), (1024, 1024, True)])
def test_kernel_equals_twin(cuda, n, m, dup):
    rng = np.random.default_rng(n + m)
    b1, b2 = _blocks(rng, 3, n, m, cuda, dup)
    best, second, idx, rbest, ridx = _assert_kernel_equals_twin(b1, b2)
    # the all-padding pair: sentinel values, first index
    assert (best[0] == -3e38).all() and (idx[0] == 0).all()
    out = hm.match_pairs_batch_fused(b1, b2)
    assert (out[0] == -1).all()


def test_kernel_splits_pairs_by_scratch(cuda, monkeypatch):
    rng = np.random.default_rng(5)
    b1, b2 = _blocks(rng, 7, 256, 256, cuda)
    per_pair = (256 // hm.TILE) * 256 * 8
    monkeypatch.setattr(hm, "SCRATCH_BYTES", 2 * per_pair)
    before = hm.launches
    _assert_kernel_equals_twin(b1, b2)
    assert hm.launches - before == 4  # ceil(7 / 2) chunks


def test_kernel_rejects_cpu_only_layouts(cuda):
    rng = np.random.default_rng(6)
    b1, b2 = _blocks(rng, 2, 128, 128, cuda)
    strided = tm.DescriptorBlock(b1.centered[:, ::2], b1.row_sum[:, ::2],
                                 b1.inv_norm[:, ::2], b1.valid[:, ::2])
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(strided, tm.DescriptorBlock(
            *(x[:, :64] for x in b2)))
    with pytest.raises(ValueError):
        hm.top2_fwd_rev(b1, tm.DescriptorBlock(*(x.cpu() for x in b2)))


def test_front_end_cuda_matches_cpu(cuda, tmp_path):
    o = synth.RoomDatasetOptions(num_images=4, width=320, height=240,
                                 focal=280.0, seed=5)
    images, K, _, _ = synth.render_room_dataset(o)
    synth.write_dataset(str(tmp_path / "images"), images)
    params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
    dbs = {}
    for dev in ("cpu", cuda):
        before = hm.launches
        _, db = ar.run_automatic_reconstruction(
            ar.AutomaticReconstructionOptions(
                workspace_path=str(tmp_path / dev),
                image_path=str(tmp_path / "images"), quality=ar.Quality.LOW,
                camera_model="PINHOLE", single_camera=True, sparse=False,
                camera_params=params), device=dev)
        assert (hm.launches > before) == (dev == cuda)
        db.close()
        dbs[dev] = Database(str(tmp_path / dev / "database.db"))
    c, g = dbs["cpu"], dbs[cuda]
    for iid in c.read_images():
        kc, kg = c.read_keypoints(iid), g.read_keypoints(iid)
        # f32 sums run in another order on the card: counts within 2%
        assert abs(len(kc) - len(kg)) <= 0.02 * len(kc)
    assert set(c.read_all_two_view_geometries()) == set(
        g.read_all_two_view_geometries())
