"""Device meshes for multi-device sharding, and the collectives of their
shards.

Port of colmap_tpu/parallel/mesh.py. The JAX package is single-controller:
one process holds a `Mesh` of devices and `shard_map` runs one program per
device, with `psum` across them. The port keeps that shape in one process:

  * a `Mesh` is an explicit list of torch devices, which may repeat a
    device. On `cuda`, `make_mesh` takes one shard per card present, up to
    the count asked for, as JAX slices its device list
    (`jax.devices()[:n]`): `num_devices=4` on a one-card host runs on that
    card. On `cpu` it makes the n shards asked for, all on the CPU (the
    counterpart of JAX's virtual CPU mesh). Virtual shards on one card are
    built explicitly, `Mesh([device] * n)`;
  * `run_shards` runs one host thread per shard, each with its shard's
    device current, and hands each a `ShardGroup`: its rank plus the
    group's collectives. `all_reduce_sum` and `all_gather` combine the
    shards' tensors in shard order on the first shard's device and send the
    same bits back to every shard, so every shard takes the same branch on
    a reduced value (a CG or LM stopping test);
  * shards on distinct devices run at once; shards that share a device
    take turns on the host, each running until it waits in a collective or
    returns, since threads that launch kernels on one card at once slow
    each other down (`python -m colmap_tpu_torch.bench_parallel` times
    it: 4 threads launching 1,000 small kernels each on one H100 took
    9.8x the time of one thread launching all 4,000);
  * a shard that raises aborts the group, so the others leave their
    collective (or their turn) with `threading.BrokenBarrierError`, and
    `run_shards` raises the shard's own error.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from colmap_tpu_torch.util import timer

logger = logging.getLogger("colmap_tpu_torch")

# seconds a shard waits in a collective for the others: a shard that neither
# arrives nor raises (a hang) fails the call instead of blocking it forever
BARRIER_TIMEOUT_S = 600.0


class Mesh:
    """An ordered list of shard devices; a device may appear more than
    once (virtual shards on one device)."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def num_distinct(self) -> int:
        return len(set(self.devices))

    @property
    def virtual(self) -> bool:
        """True when some device holds more than one shard."""
        return self.num_distinct < self.size


def resolve_num_devices(n: int, device="cuda") -> int:
    """The shard count for a `num_devices` option: 0 = every local card on
    `cuda` (the reference's 'use every GPU' default) and 1 on `cpu`."""
    if n == 0:
        return (torch.cuda.device_count()
                if torch.device(device).type == "cuda" else 1)
    return max(1, n)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of `n_devices` shards (default: one per local card on `cuda`,
    one on `cpu`). On `cuda` the mesh holds at most one shard per card
    present, as JAX's `jax.devices()[:n_devices]`: shard k goes to card
    (first + k) mod count, where `first` is the index in `device` (0 when
    none is given), for k < min(n_devices, count); a mesh asked for on
    `cuda` raises where there is no card. On `cpu` it holds `n_devices`
    shards."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(f"a mesh on {device} needs a CUDA device; "
                               "none is available")
        n = count if n_devices is None else min(int(n_devices), count)
        first = dev.index or 0
        devices = [torch.device("cuda", (first + k) % count)
                   for k in range(max(n, 0))]
    elif dev.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        devices = [torch.device("cpu")] * max(n, 0)
    else:
        raise ValueError(f"no mesh for device type {dev.type}")
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    mesh = Mesh(devices)
    logger.info("mesh: %d shards on %d distinct device(s)%s%s", mesh.size,
                mesh.num_distinct, " (virtual shards)" if mesh.virtual else "",
                f" (cut from {n_devices}: {mesh.size} card(s) present)"
                if n_devices is not None and int(n_devices) > mesh.size
                else "")
    return mesh


def shard_mesh(num_devices: int, device="cuda") -> Optional[Mesh]:
    """The mesh a `num_devices` option asks for (`resolve_num_devices`,
    then `make_mesh` on the cards present), or None where that leaves one
    shard: the caller's one-device path."""
    n = resolve_num_devices(num_devices, device)
    if n <= 1:
        return None
    mesh = make_mesh(n, device)
    return mesh if mesh.size > 1 else None


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0):
    """Pad a numpy array so its `axis` length divides `multiple`."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, rem)
    return np.pad(x, widths, constant_values=fill)


class _Rendezvous:
    """The state the shard threads of one `run_shards` call share: the
    collective's slots and result, and one lock per distinct device, which
    a shard holds while it runs (so the shards of one device take turns on
    the host and never launch at once) and lets go while it waits in a
    collective or once it is done. The turns matter only for virtual
    shards: with one shard per card no two shards share a lock."""

    def __init__(self, devices):
        self.devices = devices
        self.cond = threading.Condition()
        self.slots: List[Optional[torch.Tensor]] = [None] * len(devices)
        self.count = 0  # shards that have put their tensor in this round
        self.round = 0  # collectives completed
        self.out: Optional[torch.Tensor] = None
        self.aborted = False
        self.device_locks = {d: threading.Lock() for d in set(devices)}

    def abort(self):
        with self.cond:
            self.aborted = True
            self.cond.notify_all()


class ShardGroup:
    """One shard's handle on its group: its rank, its device and the
    collectives. Every shard must call the same collectives in the same
    order."""

    def __init__(self, rv: _Rendezvous, rank: int):
        self._rv = rv
        self.rank = rank
        self.size = len(rv.devices)
        self.device = rv.devices[rank]
        self._turn = rv.device_locks[self.device]
        self._holding = False

    def _enter(self):
        """Take this shard's turn on its device."""
        self._turn.acquire()
        self._holding = True
        if self._rv.aborted:
            self._leave()
            raise threading.BrokenBarrierError

    def _leave(self):
        """Give up this shard's turn on its device."""
        if self._holding:
            self._holding = False
            self._turn.release()

    def _collect(self, x: torch.Tensor, combine) -> torch.Tensor:
        rv = self._rv
        with rv.cond:
            if rv.aborted:
                raise threading.BrokenBarrierError
            this_round = rv.round
            rv.slots[self.rank] = x
            rv.count += 1
            if rv.count == self.size:
                # the last shard in combines, in shard order, on the first
                # shard's device
                rv.out = combine([t.to(rv.devices[0]) for t in rv.slots])
                rv.slots = [None] * self.size
                rv.count = 0
                rv.round += 1
                rv.cond.notify_all()
            else:
                self._leave()
                done = rv.cond.wait_for(
                    lambda: rv.round != this_round or rv.aborted,
                    timeout=BARRIER_TIMEOUT_S)
                if not done:
                    rv.aborted = True
                    rv.cond.notify_all()
                if rv.round == this_round:
                    raise threading.BrokenBarrierError(
                        "another shard failed" if done else
                        f"a shard waited {BARRIER_TIMEOUT_S} s in a "
                        "collective")
                # no thread waits for a device lock while it holds the
                # condition's lock (a device lock's holder needs that one)
                rv.cond.release()
                try:
                    self._enter()
                finally:
                    rv.cond.acquire()
            out = rv.out
        # every shard but the first gets its own copy of the same bits
        return out if self.rank == 0 else out.to(self.device, copy=True)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's `x` (same shape), added in shard order
        on the first shard's device; every shard gets the same bits."""
        def combine(ts):
            acc = ts[0].clone()
            for t in ts[1:]:
                acc += t
            return acc

        return self._collect(x, combine)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's `x` concatenated along axis 0 in shard order (the
        shards' lengths may differ)."""
        return self._collect(x, lambda ts: torch.cat(ts, 0))


def _device_guard(device):
    """Make `device` the thread's current CUDA device (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_shards(mesh: Mesh, fn: Callable[[ShardGroup], object]) -> list:
    """Run `fn(group)` on one thread per shard, each with its shard's device
    current; returns the results in shard order. Shards on distinct devices
    run at once; shards that share a device take turns, each running until
    it waits in a collective or returns (threads that launch on one device
    at once slow each other down). When a shard raises, the others leave
    their collectives (or their turn) with `threading.BrokenBarrierError`
    and that shard's error is raised here. The spans a shard opens have
    the span open here as their parent, and its job."""
    cuda = [d for d in mesh.devices if d.type == "cuda"]
    if cuda:
        # torch loads its CUDA linear-algebra library at the first linalg
        # call, and two threads' first calls at once fail ("lazy wrapper
        # should be called at most once"): make that call on this thread
        torch.linalg.inv_ex(torch.eye(2, device=cuda[0]))
    rv = _Rendezvous(mesh.devices)
    results: list = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size
    parent = timer.current_span()

    def body(rank):
        group = ShardGroup(rv, rank)
        try:
            group._enter()
            try:
                with _device_guard(mesh.devices[rank]), timer.adopt(parent):
                    results[rank] = fn(group)
            finally:
                group._leave()
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[rank] = e
            rv.abort()

    threads = [threading.Thread(target=body, args=(k,), name=f"shard-{k}",
                                daemon=True) for k in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        # the shard that failed first, not one that only saw the abort
        own = [e for e in raised
               if not isinstance(e, threading.BrokenBarrierError)]
        raise (own or raised)[0]
    return results
