"""Single-host data parallelism: one process per rank over
``torch.distributed`` (the port's counterpart of the JAX package's
``parallel/mesh.py`` data axis).

A dp run lists its devices (``dev = gpu:a-b`` or ``gpu:i,j``, or the
``devices=`` argument of :func:`launch`). :func:`launch` spawns one
worker per device (start method ``spawn``: the parent may hold a CUDA
context), joins them over a ``file://`` rendezvous in a fresh temporary
directory (parallel runs never fight over a port), and hands each worker
a :class:`DpContext`. NCCL is the backend when every rank has a card of
its own; gloo runs the CPU ranks and ranks that share a card (it stages
CUDA tensors through the host; NCCL refuses two ranks on one card).

The global ``batch_size`` is split evenly over the ranks, rank r holding
rows ``[r * B / W, (r + 1) * B / W)`` of every global batch, as the JAX
mesh shards the batch axis. The rendezvous and every collective carry a
timeout: a rank that raises records when it did and exits, :func:`launch`
then stops the others and raises with the traceback of the rank that
raised first (a peer whose collective broke when it exited fails later);
a rank that hangs makes the others' next collective time out, with the
same end.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: seconds a rank waits at the rendezvous and in any one collective
DEFAULT_TIMEOUT_S = 300.0
#: seconds the other ranks have to exit on their own once one has failed
#: (a rank that failed first but exits later finishes writing its record)
FAIL_GRACE_S = 2.0


@dataclasses.dataclass
class DpContext:
    """One rank of a data-parallel run over the default process group.
    ``comm_seconds`` and ``collectives`` count the host time spent
    inside :meth:`all_reduce` and :meth:`broadcast` and their number
    (with gloo the whole transfer, CUDA tensors staged through the host;
    with NCCL the enqueue only)."""
    rank: int
    world: int
    device: torch.device
    backend: str = "gloo"
    comm_seconds: float = 0.0
    collectives: int = 0

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows, ``n`` a
        multiple of the world (``Trainer`` checks ``batch_size``)."""
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``t`` over the ranks (a sum, or ``op``) in place;
        returns ``t``."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op)
        self.comm_seconds += time.perf_counter() - t0
        self.collectives += 1
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
        t0 = time.perf_counter()
        dist.broadcast(t, src)
        self.comm_seconds += time.perf_counter() - t0
        self.collectives += 1
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def allreduce_metric_pairs(pairs: Sequence[Tuple[float, int]],
                           dp: Optional[DpContext]
                           ) -> List[Tuple[float, int]]:
    """Metric accumulators ``(sum, cnt)`` summed over the ranks in
    float64 (the port of the JAX package's ``allreduce_metric_pairs``);
    the pairs as they are on one device."""
    pairs = [(float(s), int(c)) for s, c in pairs]
    if dp is None or dp.world == 1 or not pairs:
        return pairs
    dev = dp.device if dp.backend == "nccl" else torch.device("cpu")
    t = torch.tensor(pairs, dtype=torch.float64, device=dev)
    dp.all_reduce(t)
    return [(float(s), int(round(c))) for s, c in t.tolist()]


def default_backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def _dump(path: str, obj) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _worker(rank: int, devices, backend: str, init_file: str,
            timeout_s: float, out_dir: str, fn: Callable, args) -> None:
    try:
        device = torch.device(devices[rank])
        world = len(devices)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(DpContext(rank=rank, world=world, device=device,
                              backend=backend), *args)
    except Exception:
        # when it failed, on the clock that every process of the host
        # shares, for the launcher to raise the first failure
        _dump(os.path.join(out_dir, f"failed_{rank}.pkl"),
              (time.monotonic(), traceback.format_exc()))
        raise
    _dump(os.path.join(out_dir, f"result_{rank}.pkl"), result)
    dist.destroy_process_group()


def _join(ctx, out_dir: str) -> bool:
    """``ctx.join`` for up to a second. Where a rank has failed, join
    raises for the first failed exit it sees, and under load that can be
    a peer whose collective broke when the failing rank exited; so this
    raises for the rank whose :func:`_worker` recorded the earliest
    failure instead."""
    import torch.multiprocessing as mp
    try:
        return ctx.join(timeout=1.0, grace_period=FAIL_GRACE_S)
    except mp.ProcessRaisedException:
        failed = []
        for r, p in enumerate(ctx.processes):
            path = os.path.join(out_dir, f"failed_{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    failed.append((*pickle.load(f), r, p.pid))
        if not failed:
            raise
        _, tb, rank, pid = min(failed)
        raise mp.ProcessRaisedException(
            f"\n\n-- Process {rank:d} terminated with the following "
            f"error:\n{tb}", rank, pid) from None


def launch(fn: Callable, args: Tuple = (),
           devices: Sequence[Any] = ("cpu", "cpu"),
           backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S,
           deadline_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(dp, *args)`` in one spawned process per entry of
    ``devices`` (torch devices or their names; a card may repeat under
    gloo) and return the ranks' results, by rank. ``fn``, ``args`` and
    the results cross process boundaries by pickle: ``fn`` is a
    module-level function. ``backend`` defaults to
    :func:`default_backend`. If a rank fails, the others are given
    FAIL_GRACE_S to exit, then stopped, and
    ``torch.multiprocessing.ProcessRaisedException`` carries the
    traceback of the rank that raised first, whichever exit was seen
    first (``ProcessExitedException`` if a rank ended by a signal and
    none raised). ``timeout_s``
    bounds the rendezvous and each collective; ``deadline_s`` (None: no
    deadline) bounds the whole run, so that a test whose rank hangs
    outside a collective fails instead of hanging: past it the ranks are
    stopped and TimeoutError raised. ``main.run`` sets none."""
    import torch.multiprocessing as mp
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) < 2:
        raise ValueError(f"data parallelism needs two or more devices, "
                         f"got {devices}")
    backend = backend or default_backend(devices)
    if backend == "nccl" and default_backend(devices) != "nccl":
        raise ValueError(f"backend nccl needs one card per rank, got "
                         f"{devices} (gloo runs ranks that share a card)")
    with tempfile.TemporaryDirectory(prefix="cxxnet_dp_") as tmp:
        ctx = mp.start_processes(
            _worker, args=(devices, backend, os.path.join(tmp, "rendezvous"),
                           float(timeout_s), tmp, fn, tuple(args)),
            nprocs=len(devices), join=False, start_method="spawn")
        t0 = time.monotonic()
        while not _join(ctx, tmp):
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                    p.join()
                raise TimeoutError(f"data-parallel run of {fn.__name__} "
                                   f"passed its deadline of {deadline_s}s")
        out = []
        for r in range(len(devices)):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
