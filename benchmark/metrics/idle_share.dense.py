"""idle_share.dense: 100 x (1 - union of device op intervals / traced
slice), in percent, from the profiler's trace of one solve."""


def read(run):
    from benchmark.harness import union_seconds

    tr = run.tracer
    if tr is None or not tr.done or not tr.window_s:
        return None
    return 100.0 * (1.0 - union_seconds(tr.device_ops) / tr.window_s)
