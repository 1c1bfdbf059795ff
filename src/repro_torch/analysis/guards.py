"""Runtime guards: launch budgets, transfer guards, transform-leak checks
and memory budgets (``repro/analysis/guards.py``).

The static halves (lint + contracts) prove structure; these context
managers prove the invariants the port's engines advertise while they run:

- ``LaunchCounter``/``launch_budget`` — the counterparts of the
  reference's ``CompileCounter``/``compile_budget``.  The port compiles
  nothing per program: its kernels are built once per library
  (``kernels/_build``) and launched through ctypes.  The regression class
  the reference catches as a recompile per round shows up here as extra
  launches: a kernel launched per user where the engine claims one launch
  per cohort, or per row where it claims one per group.  The counter diffs
  every kernel module's ``LAUNCHES`` (and ``LAUNCHES_BF16`` where there is
  one) across the block, by wrapper name, and counts the libraries
  ``_build`` compiles inside the block, which must be 0 once they are
  built;
- ``no_implicit_transfers`` — ``"device_to_host"`` is
  ``torch.cuda.set_sync_debug_mode("error")`` for the block (a result
  read, a ``.item()``, a data-dependent shape all raise);
  ``"host_to_device"`` (the default: reading results is the engines'
  documented sync boundary) raises on a copy of host data onto the card:
  a ``TorchDispatchMode`` sees ``aten._to_copy``/``aten.copy_`` from a CPU
  tensor into a card tensor, and a ``TorchFunctionMode`` sees
  ``torch.tensor``/``as_tensor``/``asarray`` of host data with a card
  device, whose copy happens below the dispatcher's Python layer;
  ``"all"`` is both;
- ``leak_check`` — no tensor made inside a ``torch.func`` transform
  (``vmap``, ``grad``, ...) in the block outlives it: the runtime twin of
  the lint host-sync rule, as ``jax.checking_leaks`` is the reference's.
  A leaked wrapper is still a functorch tensor after its transform ended,
  and raises when it is used; a ``gc`` scan finds it;
- ``memory_budget`` — caps the block's peak: on the card
  ``torch.cuda.max_memory_allocated`` less what was allocated at entry, on
  the CPU ``utils/op_stats.ProgramStats``' peak of live storage.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import pkgutil
import re
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import resolve_device

# the device type a host-to-device copy lands on
CARD = "cuda"


class LaunchBudgetExceeded(AssertionError):
    pass


def kernel_modules() -> List:
    """Every ``repro_torch.kernels.<package>.kernel`` module."""
    import repro_torch.kernels as kernels
    return [importlib.import_module(f"{kernels.__name__}.{info.name}.kernel")
            for info in pkgutil.iter_modules(kernels.__path__)
            if info.ispkg]


def _snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    """(launches, bf16 launches) of every wrapper, by wrapper name."""
    launches: Dict[str, int] = {}
    bf16: Dict[str, int] = {}
    for mod in kernel_modules():
        launches.update(getattr(mod, "LAUNCHES", {}))
        bf16.update(getattr(mod, "LAUNCHES_BF16", {}))
    return launches, bf16


def _diff(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {n: after[n] - before.get(n, 0) for n in after
            if after[n] != before.get(n, 0)}


class LaunchCounter:
    """Context manager counting kernel launches (by wrapper name) and
    library builds in the block.

    >>> with LaunchCounter() as lc:
    ...     run_things()
    >>> lc.count(), lc.count(match="fc_chain"), lc.builds
    """

    def __init__(self) -> None:
        self._before: Optional[Tuple[Dict, Dict]] = None
        self._final: Optional[Tuple[Dict, Dict]] = None
        self.builds: List[str] = []
        self._orig_build_all = None

    def launches(self) -> Dict[str, int]:
        """Launches per wrapper since entry (only those that launched)."""
        return self._delta()[0]

    def bf16_launches(self) -> Dict[str, int]:
        """The bf16 launches among them, per wrapper."""
        return self._delta()[1]

    def _delta(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        now = self._final or _snapshot()
        return _diff(now[0], self._before[0]), _diff(now[1], self._before[1])

    def count(self, match: Optional[str] = None) -> int:
        return sum(n for name, n in self.launches().items()
                   if match is None or re.search(match, name))

    def __enter__(self) -> "LaunchCounter":
        from repro_torch.kernels import _build
        self._before, self._final = _snapshot(), None
        self._orig_build_all = orig = _build.build_all

        def counted(names=None):
            built = orig(names)
            self.builds.extend(built)
            return built

        _build.build_all = counted
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels import _build
        _build.build_all = self._orig_build_all
        self._final = _snapshot()


def _check_budget(lc: LaunchCounter, budget: Optional[int],
                  match: Optional[str]) -> None:
    if lc.builds:
        raise LaunchBudgetExceeded(
            f"built {lc.builds} inside the block: the kernel libraries must "
            f"be built before the engine runs (kernels/_build.build_all)")
    if budget is None:
        return
    n = lc.count(match)
    if n > budget:
        what = f"launches of wrappers matching {match!r}" if match \
            else "launches"
        shown = {k: v for k, v in lc.launches().items()
                 if match is None or re.search(match, k)}
        raise LaunchBudgetExceeded(
            f"{n} {what}, budget is {budget}; by wrapper: {shown}")


@contextlib.contextmanager
def launch_budget(budget: int, match: Optional[str] = None
                  ) -> Iterator[LaunchCounter]:
    """Fail if the enclosed block launches more than ``budget`` kernels
    (optionally only through wrappers whose name matches ``match``), or
    builds a kernel library."""
    with LaunchCounter() as lc:
        yield lc
    _check_budget(lc, budget, match)


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------

class ImplicitTransfer(RuntimeError):
    pass


def _on(t, device_type: str) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == device_type


class _HostCopies(TorchDispatchMode):
    """Raise on an aten copy from a CPU tensor into a ``target`` one."""

    def __init__(self, target: str = CARD):
        super().__init__()
        self.target = target

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        # checked before the op runs: a refused copy leaves no trace
        if name == "aten::_to_copy" and _on(args[0], "cpu") \
                and kwargs.get("device") is not None \
                and torch.device(kwargs["device"]).type == self.target:
            raise ImplicitTransfer(
                f"implicit host-to-device copy ({func}) of a "
                f"{tuple(args[0].shape)} {args[0].dtype} CPU tensor onto "
                f"{kwargs['device']}; stage inputs before the guarded block")
        if name == "aten::copy_" and _on(args[1], "cpu") \
                and _on(args[0], self.target):
            raise ImplicitTransfer(
                f"implicit host-to-device copy ({func}) of a "
                f"{tuple(args[1].shape)} {args[1].dtype} CPU tensor into a "
                f"{args[0].device} tensor; stage inputs before the guarded "
                f"block")
        return func(*args, **kwargs)


# data in, device by keyword
_FACTORIES = (torch.tensor, torch.as_tensor, torch.asarray)


class _HostFactories(TorchFunctionMode):
    """Raise on ``torch.tensor``/``as_tensor``/``asarray`` of host data
    onto a ``target`` device."""

    def __init__(self, target: str = CARD):
        super().__init__()
        self.target = target

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FACTORIES:
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev).type == self.target \
                    and args and not _on(args[0], self.target):
                raise ImplicitTransfer(
                    f"{func.__name__}(host data, device={dev!r}) copies "
                    f"host data onto the card inside the guarded block")
        return func(*args, **kwargs)


@contextlib.contextmanager
def _sync_errors() -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode("error")`` for the block (nothing
    to guard without a card)."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _host_to_device(target: str = CARD) -> Iterator[None]:
    with _HostFactories(target), _HostCopies(target):
        yield


@contextlib.contextmanager
def no_implicit_transfers(direction: str = "host_to_device"
                          ) -> Iterator[None]:
    """Disallow implicit transfers inside the block.

    ``direction``: ``"host_to_device"`` (default — result reads stay
    legal; the engines' documented sync boundary), ``"device_to_host"``,
    or ``"all"``."""
    if direction == "host_to_device":
        cms = [_host_to_device()]
    elif direction == "device_to_host":
        cms = [_sync_errors()]
    elif direction == "all":
        cms = [_sync_errors(), _host_to_device()]
    else:
        raise ValueError(f"unknown transfer-guard direction {direction!r}")
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


# ---------------------------------------------------------------------------
# transform leaks
# ---------------------------------------------------------------------------

class TransformLeak(AssertionError):
    pass


def _wrapped_tensors() -> Dict[int, torch.Tensor]:
    """Every live tensor that a ``torch.func`` transform wrapped."""
    is_wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    with warnings.catch_warnings():
        # the scan touches deprecated module attributes that warn on access
        warnings.simplefilter("ignore")
        return {id(o): o for o in gc.get_objects()
                if isinstance(o, torch.Tensor) and is_wrapped(o)}


@contextlib.contextmanager
def leak_check() -> Iterator[None]:
    """Raise if a tensor made inside a ``torch.func`` transform in the
    block is still alive after it."""
    gc.collect()
    before = set(_wrapped_tensors())
    yield
    gc.collect()
    leaked = [t for i, t in _wrapped_tensors().items() if i not in before]
    if leaked:
        raise TransformLeak(
            f"{len(leaked)} tensor(s) made inside a torch.func transform "
            f"outlived it (shapes {[tuple(t.shape) for t in leaked[:8]]}): "
            f"a transform's intermediate escaped into host state")


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

class MemoryBudgetExceeded(AssertionError):
    pass


@contextlib.contextmanager
def memory_budget(limit_bytes: int, device=None
                  ) -> Iterator[List[Tuple[str, int]]]:
    """Fail if the block's peak memory exceeds ``limit_bytes``.

    On the card (``device`` None or CUDA): ``max_memory_allocated`` over
    the block less what was allocated at entry (the peak statistics are
    reset at entry, so an enclosing reader of them sees this block's).
    On the CPU: ``ProgramStats``' peak of the live storage the block's ops
    made.  Yields the ``[(label, bytes)]`` record list, filled at exit;
    a violation raises at exit."""
    dev = resolve_device(device)
    records: List[Tuple[str, int]] = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        yield records
        torch.cuda.synchronize(dev)
        used = torch.cuda.max_memory_allocated(dev) - base
        label = f"{dev} peak"
    else:
        from repro_torch.utils.op_stats import ProgramStats
        with ProgramStats() as stats:
            yield records
        used = stats.peak_bytes
        label = "cpu peak"
    records.append((label, int(used)))
    if used > limit_bytes:
        raise MemoryBudgetExceeded(
            f"{label} of {used} bytes ({used / 2**20:.2f} MiB) is over the "
            f"memory budget of {limit_bytes} bytes "
            f"({limit_bytes / 2**20:.2f} MiB)")


@contextlib.contextmanager
def engine_guard(budget: Optional[int] = None, match: Optional[str] = None
                 ) -> Iterator[LaunchCounter]:
    """The combined harness guarded runs go under: a launch counter (with
    an optional budget, and no library build), no implicit host-to-device
    transfer, and no tensor leaked out of a ``torch.func`` transform."""
    with contextlib.ExitStack() as stack:
        lc = stack.enter_context(LaunchCounter())
        stack.enter_context(leak_check())
        stack.enter_context(no_implicit_transfers())
        yield lc
    _check_budget(lc, budget, match)
