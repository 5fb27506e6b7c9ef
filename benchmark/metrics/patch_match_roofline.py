"""patch_match_roofline: the traced solve's least time (rooflines/
patch_match.py: its float32 operations at its size, sources and pass) over
the device time of its kernels in the trace, in percent."""

from benchmark.rooflines import patch_match as pmr


def read(run):
    tr = run.tracer
    solves = tr.marks.get("pm_solves") if tr is not None else None
    if not tr or not tr.done or not solves:
        return None
    kernel_ms = sum(e - s for _, s, e in tr.kernels) / 1e3
    if kernel_ms <= 0:
        return None
    bound = sum(pmr.bound_ms(
        s["width"], s["height"], s["sources"], s["window_radius"],
        s["window_step"], pmr.cost_evaluations(
            s["num_iterations"], s["num_perturbations"],
            s["num_refinement_iterations"]), s["geometric"]) for s in solves)
    return 100.0 * bound / kernel_ms
