"""The scale runs: counterparts of the JAX package's scripts/ of the same
names, each run as `python -m colmap_tpu_torch.scripts.<name>`.

- `scale_run`: the mapper alone on a synthetic match database (1000
  images by default), incremental or hierarchical;
- `full_scale_run`: pixels to model on a rendered VIDEO orbit;
- `benchmark_reconstruction`: the ETH3D-style accuracy gate, on a local
  dataset or a rendered one (`--synthetic N`);
- `scaling_curve`: BA LM iterations/s and matcher pairs/s over mesh sizes.

Each keeps its JAX script's flags, defaults, report keys, gates and exit
codes, and adds `--device` (default `cuda`; `cpu` runs the device work on
the host). On `cuda` a script fails where there is no card, prints the
card's name and power limit first and reports the peak device memory.
"""

import subprocess

import torch


def add_device_argument(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device work (cuda, cpu)")


def open_device(device) -> dict:
    """Fail where `device` is a card and none is present; on a card print
    its name and power limit (`nvidia-smi`) and zero the peak memory
    counter. Returns the report's device keys."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": str(dev)}
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device} needs a CUDA device and none "
                           "is available (pass --device cpu to run on the "
                           "host)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    return {"device": str(dev), "card": card}


def peak_memory(device) -> dict:
    """{"peak_device_memory_bytes": n} since `open_device` on a card (and
    a line that prints it); {} on the host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)",
          flush=True)
    return {"peak_device_memory_bytes": peak}


def command_line(module: str, argv) -> str:
    """The report's `produced_by`: the command that ran."""
    return " ".join(["python -m", module] + list(argv))
