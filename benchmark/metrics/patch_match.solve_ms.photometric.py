"""patch_match.solve_ms.photometric: the median duration, in ms, of the
`dense.solve` spans of the photometric pass in the last finished
`dense.patch_match_stereo` job, from the program's spans
(`colmap_tpu_torch/util/timer.py`). A solve span runs from the call of
`patch_match` until its device has finished the map.

The median, so that the one solve a traced run profiles (slowed by the
profiler, and holding the profiler's stop) does not set it. In a traced
run (a 30-s window, jobs of 43-48 s) the last job is the window's only
job; `--control 1` would run one more job after it, and the benchmark's
own runs do not pass it. A program without these spans reads nothing."""

import statistics

PASS = "photometric"


def read(run):
    from colmap_tpu_torch.util import timer

    last_job = getattr(timer, "last_job", None)
    spans = last_job("dense.patch_match_stereo") if last_job else []
    ms = [1e3 * s.seconds for s in spans
          if s.name == "dense.solve" and s.attrs.get("pass") == PASS]
    return statistics.median(ms) if ms else None
