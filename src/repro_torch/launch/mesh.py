"""Process groups for the multi-device paths (``repro/launch/mesh.py``).

The reference's mesh axes become ``torch.distributed`` process groups:
``make_sweep_mesh`` is the sweep's 1-D group (``core/sweep.py`` splits
the stacked-simulation axis over it), ``make_pod_group`` the pods of an
OpportunisticSync round (``core/opportunistic_sync.py``).  ``spawn_ranks``
starts the ranks, the counterpart of the reference's forced host device
count: one process per rank, started by spawning, meeting at a
``file://`` rendezvous in a fresh temporary directory.

Backend rule (``backend_for``): ``nccl`` when every rank has a card of its
own; ``gloo`` when ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU.  Gloo reduces and broadcasts CUDA tensors: they
stay on the card and only the collective goes through the host.  Gloo has
no all-gather of CUDA tensors, so the port gathers by broadcasts.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import rank_device, resolve_device


def backend_for(world: int, n_cards: int, kind: str) -> str:
    """The collective backend of ``world`` ranks of ``kind`` (``"cuda"`` or
    ``"cpu"``) on a host with ``n_cards`` cards, rank r on card r % n."""
    if kind == "cpu":
        return "gloo"
    if kind != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {kind!r}")
    return "nccl" if n_cards >= world else "gloo"


def _initialised(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs torch.distributed initialised "
                           "(launch.mesh.spawn_ranks starts the ranks)")


def make_sweep_mesh(n_devices: int | None = None):
    """The sweep's 1-D group: ranks ``0 .. n_devices-1`` (all of them by
    default).  Each rank runs its block of every group's simulations
    (``sharding.rules.sweep_rows``), with no collective until the rows
    are gathered."""
    _initialised("make_sweep_mesh")
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return dist.group.WORLD
    if not 1 <= n_devices <= world:
        raise ValueError(f"make_sweep_mesh: {n_devices} ranks asked of a "
                         f"world of {world}")
    # every rank of the world must call new_group, members or not
    return dist.new_group(list(range(n_devices)))


def make_pod_group():
    """The pods of an OpportunisticSync round: every rank, pod p on rank
    p (the group ``make_opp_sync_round`` takes for ``group=None``)."""
    _initialised("make_pod_group")
    return dist.group.WORLD


def _rank_main(rank: int, fn: Callable, world: int, kind: str, backend: str,
               init_method: str, out_dir: str, args: Sequence[Any],
               timeout_s: float) -> None:
    dev = rank_device(kind, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, device=None, args: Sequence = (),
                tmpdir: str | None = None, timeout_s: float = 600.0
                ) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned ranks
    and return their results in rank order.

    ``device`` is ``None`` (the card) or ``"cpu"``; rank r runs on
    ``device.rank_device`` (``cuda:(r % cards)``), the backend is
    ``backend_for``'s.  ``fn`` and ``args`` are pickled (``fn`` by its
    import path) and each result comes back through ``torch.save`` (CUDA
    tensors load on the CPU).  The parent joins every rank: a rank that
    raises or dies stops the others and raises here.  ``timeout_s``
    bounds each collective.  The rendezvous file and the results live in
    a temporary directory under ``tmpdir``, removed at the end."""
    kind = resolve_device(device).type
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    backend = backend_for(world, n_cards, kind)
    tmp = tempfile.mkdtemp(prefix="ranks-", dir=tmpdir)
    try:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, kind, backend, init, tmp,
                              tuple(args), timeout_s),
            nprocs=world, join=False, start_method="spawn")
        while not ctx.join():
            pass
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
