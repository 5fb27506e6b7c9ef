"""PatchMatch's least time on the card (`mvs/patch_match.py`), copied from
`colmap_tpu_torch/bench_patch_match.py` (`cost_evaluations`, `bound_ms`)
and extended by the geometric term of the second pass.

The port evaluates (1 + num_iterations * (4 + num_perturbations) + 4 *
num_refinement_iterations) whole-image equivalents of the cost (a
propagation candidate only on the active checkerboard colour). Each
evaluation costs, per pixel and source, FLOPS_PER_TAP float32 operations
at each window tap and, in the geometric pass, GEOM_FLOPS_PER_SOURCE more
for the forward-backward reprojection (`_geom_cost`), against the card's
float32 peak outside the tensor cores.
"""

from benchmark.rooflines.peaks import FP32_FLOPS_PER_S

# per tap and source in _photometric_cost: the affine warp (3 adds), two
# divisions, the normalisation to grid_sample's [-1, 1] (2 multiply-adds),
# the bilinear sample (2 floors, 4 fraction terms, 4 weights, 4 multiplies,
# 3 adds: 17), the weighted products (6) and the seven running sums (7);
# the compares of the in-image test are not counted
FLOPS_PER_TAP = 3 + 2 + 4 + 17 + 6 + 7
# per source in _geom_cost: the point into the source (R X + t: 18), its
# projection (15) and division (2, clamp 1), the bilinear depth sample
# (17), the back-projected ray (15) scaled by the depth less t (6), back
# into the reference (R^T: 15), its projection (15, clamp 1, 2 divisions),
# the pixel distance (6), the clamp and mask (2), and the regulariser's
# multiply-add (2)
GEOM_FLOPS_PER_SOURCE = 18 + 15 + 3 + 17 + 15 + 6 + 15 + 18 + 6 + 2 + 2


def cost_evaluations(num_iterations: int, num_perturbations: int,
                     num_refinement_iterations: int) -> int:
    """Whole-image equivalents of the cost one solve evaluates."""
    return (1 + num_iterations * (4 + num_perturbations)
            + 2 * num_refinement_iterations * 2)


def flops(width: int, height: int, n_src: int, window_radius: int,
          window_step: int, evaluations: int, geometric: bool) -> float:
    taps = (2 * window_radius // window_step + 1) ** 2
    per = taps * FLOPS_PER_TAP + (GEOM_FLOPS_PER_SOURCE if geometric else 0)
    return float(width * height * evaluations * n_src * per)


def bound_ms(width: int, height: int, n_src: int, window_radius: int,
             window_step: int, evaluations: int, geometric: bool) -> float:
    """The least ms one map's solve could take: its float32 operations
    over the float32 peak (the cost is bound by operations)."""
    return flops(width, height, n_src, window_radius, window_step,
                 evaluations, geometric) / FP32_FLOPS_PER_S * 1e3
