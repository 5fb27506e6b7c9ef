"""The benchmark's input generators against the port's, on the CPU.

The copies draw from a torch.Generator; here they are handed the port's
own numpy draws (recorded from its generator) and must rebuild what the
port builds."""

import numpy as np
import torch

from benchmark.inputs import render, workspace
from colmap_tpu_torch.scene import synthetic_images


class _Recording:
    """A numpy Generator that keeps every draw, in order."""

    def __init__(self, rng):
        self.rng = rng
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, out))
            return out
        return call


def _record(monkeypatch):
    made = []
    real = np.random.default_rng

    def factory(seed=None):
        if made:  # only the generator under test records
            return real(seed)
        made.append(_Recording(real(seed)))
        return made[-1]
    monkeypatch.setattr(np.random, "default_rng", factory)
    return made


def _texture_grids(calls, n_faces):
    it = iter(calls)
    return [[torch.as_tensor(next(it)[1]) for _ in render.TEXTURE_CELLS]
            for _ in range(n_faces)]


def test_orbit_renderer_rebuilds_the_ports_images(monkeypatch):
    opts = synthetic_images.OrbitDatasetOptions(
        num_images=40, width=80, height=60, focal=70.0, texture_res=64,
        seed=4)
    made = _record(monkeypatch)
    images, K, Rs, ts, depths = synthetic_images.render_orbit_dataset(
        opts, return_depth=True)
    monkeypatch.undo()
    orbit = render.Orbit(num_images=40, width=80, height=60, focal=70.0,
                         texture_res=64)
    faces = render.orbit_faces(orbit)
    tex = torch.stack([render.texture_from_grids(g, 64) for g in
                       _texture_grids(made[0].calls, len(faces))])
    frames = [0, 7, 13, 39]
    R, t = render.orbit_poses(orbit, frames)
    np.testing.assert_allclose(R, Rs[frames], atol=1e-12)
    np.testing.assert_allclose(t, ts[frames], atol=1e-12)
    np.testing.assert_allclose(render.intrinsics(80, 60, 70.0), K)
    img, dep = render.render(tex, faces, K, R, t, 80, 60, rows=24)
    diff = np.abs(img.numpy().astype(int)
                  - np.stack([images[f] for f in frames]).astype(int))
    assert (diff <= 1).mean() >= 0.999
    ref = np.stack([depths[f] for f in frames])
    assert ((dep.numpy() > 0) == (ref > 0)).mean() >= 0.999
    both = (dep.numpy() > 0) & (ref > 0)
    np.testing.assert_allclose(dep.numpy()[both], ref[both], rtol=1e-5)


def test_textures_draw_on_a_generator():
    g = torch.Generator().manual_seed(1)
    a = render.draw_textures(2, 64, g)
    assert a.shape == (2, 64, 64) and a.dtype == torch.uint8
    assert int(a.min()) == 0 and int(a.max()) >= 254


def test_texture_weights_default_to_the_ports():
    g = [torch.randn((c, c), generator=torch.Generator().manual_seed(c))
         for c in render.TEXTURE_CELLS]
    ports = [64 // c / 64 * 4 for c in render.TEXTURE_CELLS]
    assert torch.equal(render.texture_from_grids(g, 64),
                       render.texture_from_grids(g, 64, ports))
    flat = render.texture_from_grids(g, 64, [1.0] * len(g))
    assert not torch.equal(flat, render.texture_from_grids(g, 64))


def test_workspace_truth_is_the_rendered_surface(tmp_path):
    """The workspace's true normals are the planes of its true depth (a
    normal n of a plane through X = d ray holds n . X constant across a
    face), face the camera, and the camera is written as given."""
    from colmap_tpu_torch.scene import reconstruction_io

    orbit = render.Orbit(num_images=100, width=96, height=72,
                         texture_res=64)
    K = np.array([[80.3, 0, 48.0], [0, 80.9, 37.1], [0, 0, 1.0]])
    truth = workspace.build(str(tmp_path), orbit, [0, 5, 10], 3, "cpu",
                            K=K, texture_cells=(4, 8, 16),
                            texture_weights=(1, 1, 1))
    n, H, W = truth["depth"].shape
    ys, xs = np.mgrid[0:H, 0:W]
    rays = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                     np.ones((H, W))], -1)
    for i in range(n):
        seen = truth["depth"][i] > 0
        nm = truth["normal"][i]
        assert np.allclose(np.linalg.norm(nm[seen], axis=-1), 1, atol=1e-5)
        assert (np.sum(nm * rays, -1)[seen] < 0).all()
        assert not nm[~seen].any()
        # n . X across each 2x2 block that sees one plane
        X = rays * truth["depth"][i][..., None]
        off = np.sum(nm * X, -1)
        same = seen[:-1, :-1] & seen[1:, 1:] & np.all(
            nm[:-1, :-1] == nm[1:, 1:], -1)
        gap = np.abs(off[:-1, :-1] - np.sum(nm[:-1, :-1] * X[1:, 1:], -1))
        assert np.median(gap[same]) < 1e-4
    rec = reconstruction_io.read_model(str(tmp_path / "sparse"))
    cam = rec.cameras[1]
    np.testing.assert_allclose(cam.params, [80.3, 80.9, 48.0, 37.1])
    assert (cam.width, cam.height) == (96, 72)
