"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel package keeps its sources in ``<package>/csrc/``; every ``.cu``
file there becomes one shared library with a plain C interface, compiled
for Hopper (``sm_90a``) into ``build/kernels/`` at the root of the checkout.
The file name carries a hash of the package's sources and of the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per source and waits for all of them.

``Library`` binds one library's C functions for the kernel wrappers: each
launch goes on the current stream, raises on a CUDA error and counts.

Nothing is built when a module is imported: the first CUDA launch builds
what it needs.  A missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

# one entry per .cu source: library name -> source path
SOURCES: Dict[str, Path] = {
    "fused_cnn": _PKG / "fused_cnn" / "csrc" / "fused_cnn.cu",
    "delta_codec": _PKG / "delta_codec" / "csrc" / "delta_codec.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "wkv6": _PKG / "wkv6" / "csrc" / "wkv6.cu",
    "moe_dispatch": _PKG / "moe_dispatch" / "csrc" / "moe_dispatch.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH nor under $CUDA_HOME/bin; the "
                       "CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = SOURCES[name].parent
    for f in sorted(csrc.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all(names: Iterable[str] | None = None) -> Dict[str, float]:
    """Compile the named libraries (all by default) that are not built yet,
    one ``nvcc`` each, in parallel.  Returns seconds per library built; the
    compiler's output (register and spill counts) goes to a ``.log``
    beside each library."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=log,
                                     stderr=subprocess.STDOUT), tmp, out, log)
    secs = {}
    for n, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[n] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed ({rc}) for {SOURCES[n]}:\n"
                + out.with_suffix(".log").read_text())
        os.replace(tmp, out)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def on_cpu(*ts) -> bool:
    """True for CPU tensors, False for CUDA tensors of one device, else
    raise: a wrapper runs its plain twin only on the CPU.  A tensor
    subclass (a ``DTensor``, a fake tensor) raises too: the kernels read
    and write through raw pointers, which such a tensor does not have (or
    has only for its local shard)."""
    odd = sorted({type(t).__name__ for t in ts
                  if type(t) not in (torch.Tensor, torch.nn.Parameter)})
    if odd:
        raise TypeError(f"kernels take plain tensors, got {odd}: sharded "
                        f"and traced programs take the einsum paths")
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"kernels take tensors on one CPU or CUDA device, got "
                     f"{sorted(str(t.device) for t in ts)}")


def refuse_grad(name: str, *ts) -> None:
    """Raise where autograd would record through a forward-only kernel.

    The kernel writes its output through a raw pointer, so autograd never
    sees it: a gradient to its inputs would be cut without a word.  The
    reference's Pallas kernel has no backward either (``jax.grad`` through
    it fails); training takes the reference's einsum path instead.  On the
    CPU as on the card, so that the CPU tests see what the card would do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} has no backward (nor has the reference's Pallas "
            f"kernel): call it under torch.no_grad() or on inputs that need "
            f"no gradient; training goes through the einsum path "
            f"(impl='xla', wkv_impl='xla')")


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def compute_dtype(name: str, t) -> torch.dtype:
    """The compute dtype a kernel takes from its input ``t`` (f32 or bf16);
    any other dtype raises."""
    if t.dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got "
                        f"{t.dtype}")
    return t.dtype


def check(name: str, t, shape, dtype=torch.float32, align: int = 1) -> None:
    """Raise unless ``t`` has this dtype and shape, is contiguous and its
    data pointer is ``align``-byte aligned (what a kernel assumes)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")


class Library:
    """One library's C functions, with their ctypes signatures (every
    function takes the stream last and returns a ``cudaError_t``), and the
    launch counts of the wrappers that call them."""

    def __init__(self, name: str, signatures: Dict[str, List],
                 error_string: str, launches: Dict[str, int]):
        self.name = name
        self.signatures = signatures
        self.error_string = error_string
        self.launches = launches
        self._lib = None

    def _bound(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes + [ctypes.c_void_p]
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, self.error_string)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, counter: str, fn: str, *args) -> None:
        """Call ``fn`` on the current stream; raise if it returns an error,
        else add one to ``counter``'s launches."""
        lib = self._bound()
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{fn}: CUDA error {rc}: "
                               f"{getattr(lib, self.error_string)(rc).decode()}")
        self.launches[counter] += 1

    def reset(self) -> None:
        """Set every launch count to 0."""
        for name in self.launches:
            self.launches[name] = 0
