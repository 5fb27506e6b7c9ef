"""Time the matcher kernel K1 (csrc/matcher_top2.cu) on one GPU.

    python -m colmap_tpu_torch.bench_matcher [--other PATH.cu ...]

At B=8, N=M=8192 (the capacity ceiling), B=190, N=M=1024 (one DSLR pair
block) and B=32, N=M=2048 (one VIDEO pair block at Quality.LOW) it times,
in one process on one card:
- the kernel as built by the wrapper ("this");
- `--other`: builds of other sources with the same C interface (for
  example an earlier commit's matcher_top2.cu, copied out of git), each
  under its file name;
- the plain twin, and `torch._int_mm` over the same products (one call
  per pair; a yardstick the port never calls).
`--ablate` adds two wrong-answer builds of this source, the products
without the epilogue and the epilogue without the products, to show which
limits it. Every other build is first held bit for bit against the twin.
Builds are timed in turns (others, this, this, others reversed). Prints
one JSON line per shape and writes them all to `--out`; `--sass DIR` also
writes each build's SASS (cuobjdump) there and prints the opcode counts of
the sweep kernel's main loop. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

import torch

from colmap_tpu_torch import cuda_build
from colmap_tpu_torch.features import hopper_matcher as hm
from colmap_tpu_torch.features import matching as mm

SHAPES = ((8, 8192), (190, 1024), (32, 2048))
ABLATIONS = ("products_only", "epilogue_only")  # wrong answers, timed only

# H100 SXM, published dense peaks at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def matcher_bytes(B: int, n: int, m: int) -> int:
    """Bytes K1's function must move: each input read once (int8 rows,
    f32 row sums and inverse norms, byte flags), each output written once
    (forward best/second/index, reverse best/index)."""
    return B * (n + m) * (128 + 4 + 4 + 1) + B * n * 12 + B * m * 8


def partial_bytes(B: int, n: int, m: int) -> int:
    """The two-pass reverse's (B, N/64, M) (best, row) buffer, written and
    read back: what the design moves beyond the function's own bytes."""
    return 2 * B * (n // hm.TILE) * m * 8


def bound_ms(B: int, n: int, m: int):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    function's bytes over the HBM rate and its int8 products
    (2*128 per similarity) over the int8 tensor-core peak."""
    t_bytes = matcher_bytes(B, n, m) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 128 * B * n * m / INT8_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def random_blocks(B: int, n: int, seed: int):
    """A batch of matchable pairs on the card: b2 is a permuted, noised b1,
    with padding rows on both sides."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d1 = torch.randint(0, 200, (B, n, 128), generator=g, device="cuda",
                       dtype=torch.int32)
    perm = torch.randperm(n, generator=g, device="cuda")
    noise = torch.randint(-3, 4, (B, n, 128), generator=g, device="cuda",
                          dtype=torch.int32)
    d2 = torch.clamp(d1[:, perm] + noise, 0, 255)
    v1 = torch.ones(B, n, dtype=torch.bool, device="cuda")
    v2 = v1.clone()
    v1[:, n - n // 8:] = False
    v2[0, : n // 4] = False
    return (mm.prepare_descriptors(d1.to(torch.uint8), v1),
            mm.prepare_descriptors(d2.to(torch.uint8), v2))


def int_mm_ms(b1, b2, reps: int):
    """torch._int_mm on each pair's centered int8 product (B calls): the
    cost of an unfused route's products alone, or None where the build of
    torch has no int8 matrix product."""
    B = b1.centered.shape[0]
    a = [b1.centered[i] for i in range(B)]
    bt = [b2.centered[i].t() for i in range(B)]
    try:
        torch._int_mm(a[0], bt[0])
    except RuntimeError:
        bt = [x.contiguous() for x in bt]
        try:
            torch._int_mm(a[0], bt[0])
        except RuntimeError as e:
            print(f"[int_mm] unavailable: {e}", file=sys.stderr)
            return None

    def run():
        for i in range(B):
            torch._int_mm(a[i], bt[i])

    return cuda_ms(run, reps)


def sass_loop_counts(sass: str, kernel: str = "matcher_sweep_kernel"):
    """Opcode counts of the longest loop (the widest backward branch) of
    `kernel` in cuobjdump -sass output: the sweep's main loop."""
    lines = sass.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "Function :" in ln and kernel in ln)
    end = next((i for i, ln in enumerate(lines)
                if i > start and "Function :" in ln), len(lines))
    ins = []
    for ln in lines[start:end]:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if m:
            toks = m.group(2).split()
            op = toks[1] if toks[0].startswith("@") else toks[0]
            ins.append((int(m.group(1), 16), op.split(".")[0], m.group(2)))
    loop = (0, -1)
    for addr, op, body in ins:
        m = re.search(r"BRA (?:`\(\.L_x_\d+\) )?0x([0-9a-f]+)", body)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            if addr - int(m.group(1), 16) > loop[1] - loop[0]:
                loop = (int(m.group(1), 16), addr)
    return collections.Counter(op for addr, op, _ in ins
                               if loop[0] <= addr <= loop[1])


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def _ptxas_lines(name: str):
    log = cuda_build.build_logs.get(name, "")
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", nargs="*", default=[],
                    help="other .cu files with the same C interface")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out/bench_matcher.json")
    ap.add_argument("--sass", help="directory for each build's SASS")
    ap.add_argument("--ablate", action="store_true",
                    help="also time products-only and epilogue-only builds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_matcher needs a CUDA device")
    name = card()
    print(name, flush=True)

    builds = [("this", "matcher_top2.cu", ())] + [
        (os.path.splitext(os.path.basename(p))[0], os.path.abspath(p), ())
        for p in args.other]
    if args.ablate:
        builds += [("products_only", "matcher_top2.cu",
                    ("-DMATCHER_SKIP_EPILOGUE",)),
                   ("epilogue_only", "matcher_top2.cu",
                    ("-DMATCHER_SKIP_PRODUCTS",))]
    libs = {}
    for label, src, defines in builds:
        libs[label] = hm.bind(cuda_build.load_library(
            f"matcher_top2_{label}", [src], flags=(*defines, "-Xptxas", "-v")))
        print(f"[build] {label}: {_ptxas_lines(f'matcher_top2_{label}')}",
              flush=True)
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                                     "cuobjdump")
            res = subprocess.run([cuobjdump, "-sass", libs[label]._name],
                                 capture_output=True, text=True)
            with open(os.path.join(args.sass, f"{label}.sass"), "w") as f:
                f.write(res.stdout or res.stderr)
            counts = sass_loop_counts(res.stdout)
            print(f"[sass] {label}: main loop {sum(counts.values())} "
                  f"instructions: {dict(counts.most_common())}", flush=True)
    text = cuda_build.ptx("matcher_top2.cu")
    print(f"[ptx] matcher_top2.cu: {text.count('mma.sync.aligned.m16n8k32')} "
          f"mma.sync m16n8k32, {text.count('dp4a')} dp4a", flush=True)

    order = list(libs)[1:] + ["this"]
    order = order + order[::-1]
    rows = []
    for B, n in SHAPES:
        b1, b2 = random_blocks(B, n, seed=B)
        ref = hm._top2_fwd_rev_reference(b1, b2)
        equal = {}
        for label, lib in libs.items():
            out = hm._top2_fwd_rev_kernel(b1, b2, lib)
            if label not in ABLATIONS:
                equal[label] = all(torch.equal(a, r)
                                   for a, r in zip(out, ref))
        del ref
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(cuda_ms(
                lambda: hm._top2_fwd_rev_kernel(b1, b2, libs[label]),
                args.reps))
        plain = cuda_ms(lambda: hm._top2_fwd_rev_reference(b1, b2), 3)
        bound, by = bound_ms(B, n, n)
        row = {"B": B, "N": n, "M": n, "card": name, "equal": equal,
               "ms": times, "plain_ms": plain, "bound_ms": bound,
               "bound_by": by,
               "with_partials_ms": (matcher_bytes(B, n, n)
                                    + partial_bytes(B, n, n))
               / HBM_BYTES_PER_S * 1e3,
               "share": {k: bound / min(v) for k, v in times.items()},
               "int_mm_ms": int_mm_ms(b1, b2, 5)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del b1, b2
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    if not all(all(r["equal"].values()) for r in rows):
        sys.exit("a build differs from the twin")


if __name__ == "__main__":
    main()
