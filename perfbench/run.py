"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card; without one (or with fewer than the cell asks for) it
exits with code 2 and prints no result.  Every cache of a build stays in
the checkout: the port's kernels under ``build/kernels/``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` under ``build/``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    # libraries that would load JAX by themselves stay off it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
