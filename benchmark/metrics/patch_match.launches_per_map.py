"""patch_match.launches_per_map: kernels launched in the traced solves,
from the profiler's device trace, over the number of solves traced."""


def read(run):
    tr = run.tracer
    solves = tr.marks.get("pm_solves") if tr is not None else None
    if not tr or not tr.done or not solves:
        return None
    return len(tr.kernels) / len(solves)
