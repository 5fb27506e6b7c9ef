"""The benchmark's bound arithmetic against the port's bench scripts."""

import pytest

from benchmark.rooflines import patch_match as pmr
from colmap_tpu_torch import bench_patch_match
from colmap_tpu_torch.mvs.patch_match import PatchMatchOptions


def test_patch_match_photometric_bound_is_bench_patch_matchs():
    o = PatchMatchOptions()
    ev = pmr.cost_evaluations(o.num_iterations, o.num_perturbations,
                              o.num_refinement_iterations)
    assert ev == bench_patch_match.cost_evaluations(o)
    w, h = bench_patch_match.SIZE
    got = pmr.bound_ms(w, h, bench_patch_match.SOURCES, o.window_radius,
                       o.window_step, ev, geometric=False)
    assert got == pytest.approx(bench_patch_match.bound_ms(
        w, h, bench_patch_match.SOURCES, o), rel=1e-12)


def test_patch_match_geometric_term_adds_per_source():
    o = PatchMatchOptions()
    ev = pmr.cost_evaluations(o.num_iterations, o.num_perturbations,
                              o.num_refinement_iterations)
    photo = pmr.flops(640, 480, 8, o.window_radius, o.window_step, ev, False)
    geom = pmr.flops(640, 480, 8, o.window_radius, o.window_step, ev, True)
    assert geom - photo == 640 * 480 * ev * 8 * pmr.GEOM_FLOPS_PER_SOURCE
