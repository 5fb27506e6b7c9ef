"""dense.host_ms_per_map: the controller's time outside the solves, per
map, from the program's spans (`colmap_tpu_torch/util/timer.py`): of the
last finished `dense.patch_match_stereo` job, its duration less the time
in which a `dense.solve` span was open, over the number of those spans,
in ms. On one shard the solves run one after another and that time is
their sum; on several shards (`num_devices` > 1) their threads overlap,
and the union of their intervals is taken, so the metric stays the host
time in which no solve ran.

That is the workspace load, each problem's upload and fetch, the passes'
bookkeeping and the map writes. In a traced run (a 30-s window, jobs of
43-48 s) the last job is the window's only job; `--control 1` would run
one more job after it, and the benchmark's own runs do not pass it. A
program without these spans reads nothing."""


def read(run):
    from colmap_tpu_torch.util import timer

    last_job = getattr(timer, "last_job", None)
    spans = last_job("dense.patch_match_stereo") if last_job else []
    solves = [s for s in spans if s.name == "dense.solve"]
    if not solves:
        return None
    job = spans[-1]
    solving, reach = 0, None
    for s in sorted(solves, key=lambda s: s.start):
        lo = s.start if reach is None else max(s.start, reach)
        solving += max(s.end - lo, 0)
        reach = s.end if reach is None else max(reach, s.end)
    return 1e-6 * (job.end - job.start - solving) / len(solves)
