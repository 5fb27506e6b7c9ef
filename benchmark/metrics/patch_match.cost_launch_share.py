"""patch_match.cost_launch_share: of the kernel launches in the traced
solve, the share, in percent, issued inside the program's
`patch_match.cost` spans (each `_set_cost` call of `mvs/patch_match.py`,
which shows as a profiler range while the profiler records).

Launches are the launch calls in the host trace, of the CUDA runtime
(`cudaLaunchKernel*`) and of libcuda (`cuLaunchKernel*`); one counts as
inside when it starts inside a range. It reads nothing when the trace holds no
launch (on the CPU) or no `patch_match.cost` range (a program without
the span)."""

import bisect

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
RANGE = "patch_match.cost"


def _union(ranges):
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(run):
    tr = run.tracer
    if tr is None or not tr.done:
        return None
    launches = [s for n, s, _ in tr.host_ops if n.startswith(LAUNCHES)]
    ranges = _union((s, e) for n, s, e in tr.host_ops if n == RANGE)
    if not launches or not ranges:
        return None
    starts = [s for s, _ in ranges]
    inside = 0
    for t in launches:
        k = bisect.bisect_right(starts, t) - 1
        inside += k >= 0 and t <= ranges[k][1]
    return 100.0 * inside / len(launches)
