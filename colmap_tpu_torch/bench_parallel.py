"""Time concurrent kernel launches on one card.

    python -m colmap_tpu_torch.bench_parallel [--out bench_parallel.json]

One thread launches `threads * ops` small kernels on card 0, then
`threads` threads launch `ops` each at once on the same card; the ratio of
the two times is why parallel/mesh.run_shards lets the shards of one card
take turns on the host. Prints one JSON line (and writes it to `--out`)
with the card's name beside the numbers. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import torch


def launch_contention(threads: int = 4, ops: int = 1000) -> dict:
    """Seconds for one thread to launch threads * ops small kernels on card
    0, and for `threads` threads to launch `ops` each at once."""
    x = torch.ones(16, device="cuda:0")

    def work(n):
        with torch.cuda.device(0):
            y = x
            for _ in range(n):
                y = y + 1
        return y

    work(100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work(threads * ops)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    pool = [threading.Thread(target=work, args=(ops,))
            for _ in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    torch.cuda.synchronize()
    many = time.perf_counter() - t0
    return dict(threads=threads, ops_per_thread=ops, one_thread_s=one,
                threads_s=many, ratio=many / one)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_parallel needs a CUDA device")
    res = dict(device=torch.cuda.get_device_name(0),
               device_count=torch.cuda.device_count(),
               launch_contention=launch_contention())
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
