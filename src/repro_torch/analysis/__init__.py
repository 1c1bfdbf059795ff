"""repro_torch.analysis — repo-specific static analysis for the port
(``repro/analysis``).

Four parts:

- ``lint``: AST rules over the port's own invariants (scheme-registry
  dispatch, host-sync-free traced bodies, generator discipline,
  dtype-policy threading, numpy-free hot modules, no swallowed faults);
- ``contracts``: shape/dtype contracts of the public entry points, on
  fake tensors where the code is plain torch and for real at tiny sizes
  where it goes through a kernel wrapper (see its docstring);
- ``guards``: runtime context managers (launch budgets, transfer guards,
  transform-leak checks, memory budgets) the guarded runs go under;
- ``ir``: the IR auditors on aten graphs from ``make_fx`` (``--ir``): the
  K-parameterized program registry, the liveness walk with per-buffer
  provenance, the bf16→f32 promotion audit and the K-scaling gate
  against the committed ``src/repro_torch/analysis/scaling.json`` (see
  its docstring).  Their programs are traced on the CPU through the
  kernels' twins, as the reference traces its Pallas bodies with
  ``interpret=True``.

CLI: ``python -m repro_torch.analysis`` — file:line findings, exit 1 on
any finding that is neither pragma'd (``# analysis: ok=<rule>``) nor in
the baseline (``src/repro_torch/analysis/baseline.txt``).

The reference's rules and their counterparts here:

=================  ===================  ==================================
reference rule     port rule            what changes
=================  ===================  ==================================
``scheme-branch``  ``scheme-branch``    the port's paths; same logic
``np-hot``         ``np-hot``           the port's hot modules; same
                                        ``ALLOWED_ATTRS``
``except-swallow`` ``except-swallow``   the port's serving/transport/faults
``host-sync``      ``host-sync``        torch's syncs: ``.item()``,
                                        ``.cpu()``, ``.to("cpu")``,
                                        ``synchronize()``, data-dependent
                                        shapes; traced scope is the
                                        ``torch.func`` transforms,
                                        ``torch.compile``, checkpointing,
                                        CUDA graphs, ``autograd.Function``
                                        and the ``build_*``/``make_*``
                                        closures
``dtype-thread``   ``dtype-thread``     torch's casts: ``.to(dtype)``,
                                        ``.float()``, ``.half()``,
                                        ``.bfloat16()``, ``.type()``
``rng-reuse``      ``rng-reuse``        a draw without ``generator=``, and
                                        one seed re-seeding a generator
                                        twice (torch has no keys)
``jit-donate``     none                 eager PyTorch has no compiled
                                        program that copies undonated
                                        inputs: the engines update their
                                        carries in place
``ir-trace``       ``ir-trace``         a program that fails to trace to
                                        an aten graph (``make_fx``, real
                                        mode, CPU tensors)
``ir-dtype``       ``ir-dtype``         aten has no implicit convert: any
                                        op minting f32 from bf16 operands
                                        fires; only a conversion
                                        (``_to_copy``, ``copy_``) with a
                                        visible cast on its line is
                                        exempt.  The reference's
                                        ``preferred_element_type``
                                        exemption has no counterpart
                                        (aten products return their
                                        operands' dtype)
``ir-alias``       none                 the port donates nothing, so there
                                        is no donation for a compiler to
                                        drop (as ``jit-donate``)
``ir-scaling``     ``ir-scaling``       the port's record and budgets
                                        (``core``, ``kernels``,
                                        ``models``, arguments and torch's
                                        own frames declared O(K))
=================  ===================  ==================================
"""
from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.guards import (ImplicitTransfer,
                                         LaunchBudgetExceeded, LaunchCounter,
                                         MemoryBudgetExceeded, TransformLeak,
                                         engine_guard, launch_budget,
                                         leak_check, memory_budget,
                                         no_implicit_transfers)
from repro_torch.analysis.lint import all_rules, lint_paths, lint_source

__all__ = [
    "Baseline", "Finding", "ImplicitTransfer", "LaunchBudgetExceeded",
    "LaunchCounter", "MemoryBudgetExceeded", "TransformLeak", "engine_guard",
    "launch_budget", "leak_check", "memory_budget", "no_implicit_transfers",
    "all_rules", "lint_paths", "lint_source",
]
