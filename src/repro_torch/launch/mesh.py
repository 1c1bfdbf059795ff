"""Process groups and device meshes for the multi-device paths
(``repro/launch/mesh.py``).

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

The dry run (``launch/dryrun.py``) lays its programs out on the
reference's production meshes, as ``DeviceMesh``es over the current world:
``make_production_mesh`` (16 x 16 ``("data", "model")``, or 2 x 16 x 16
``("pod", "data", "model")``) and ``make_debug_mesh`` (2 x 2 x 2).  The
world is a fake one (``fake_world``: every collective a no-op, rank 0 of
n) for the production sizes, or real spawned ranks for the debug mesh.

The roofline constants are one H100 SXM5's, in place of the reference's
TPU v5e ones.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, Iterator, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import rank_device, resolve_device

# One H100 SXM5 (NVIDIA's datasheet), the per-chip rates of the roofline.
# Dense bf16 tensor-core rate, without sparsity (FLOP/s):
PEAK_FLOPS_BF16 = 989.4e12
# HBM3 bandwidth (bytes/s):
HBM_BW = 3.35e12
# One 400 Gb/s NDR InfiniBand port per GPU (bytes/s, one direction).  A
# node holds 8 GPUs, so every 16-wide axis of the 256- and 512-GPU meshes
# spans nodes and a ring over it runs at the network's rate:
LINK_BW = 50e9
# NVLink 4 within a node, 450 GB/s a direction (bytes/s); no roofline term
# uses it, since no mesh axis fits inside one node:
NVLINK_BW = 450e9

PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


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


def make_mesh(shape, axes, device=None, what: str = "make_mesh"):
    """A ``DeviceMesh`` of ``shape`` named ``axes``, of ``device``'s type
    (``None``: the card), over the current world, which must have exactly
    as many ranks as the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    _initialised(what)
    kind = resolve_device(device).type
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"{what}: a {' x '.join(map(str, shape))} mesh needs "
                         f"{need} ranks, the world has {world}")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod, ``("data", "model")``; 2 x 16 x 16 = 512
    ranks over two pods, ``("pod", "data", "model")``.  A ``DeviceMesh``
    of ``device``'s type (``None``: the card) over the current world,
    which must have exactly that many ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), MULTI_POD_AXES, device,
                         "make_production_mesh")
    return make_mesh((16, 16), PRODUCTION_AXES, device,
                     "make_production_mesh")


def make_debug_mesh(n_pods: int = 2, n_data: int = 2, n_model: int = 2,
                    device=None):
    """The small ``("pod", "data", "model")`` mesh of the CI-scale tests
    (8 ranks by default)."""
    return make_mesh((n_pods, n_data, n_model), MULTI_POD_AXES, device,
                     "make_debug_mesh")


@contextlib.contextmanager
def fake_world(world: int) -> Iterator[None]:
    """A world of ``world`` ranks in which this process is rank 0 and every
    collective does nothing (``torch.distributed``'s ``fake`` backend):
    enough to lay out and trace a program on a production mesh from one
    process.  Opened here and destroyed on exit, whatever happens inside;
    it refuses to open over a process group that is already initialised."""
    # the fake backend's store lives with torch's test utilities
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
