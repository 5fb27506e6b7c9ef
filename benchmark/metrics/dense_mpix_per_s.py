"""dense_mpix_per_s: megapixels of finished (geometric-pass) depth maps
over the whole window, by the host clock."""


def read(run):
    if run.cell["traffic"] != "dense":
        return None
    return run.totals["mpix"] / run.totals["window_s"]
