"""setup_s: seconds from the process's start to the end of set-up (imports,
inputs made from the seed, builds, warm-up), by the host clock."""


def read(run):
    return run.totals.get("setup_s")
