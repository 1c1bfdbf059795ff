"""IR-level program auditor — the aten-graph half of
``repro_torch.analysis`` (``repro/analysis/ir``).

The lint and the contracts see source text and output signatures.  This
subpackage works on the traced program itself, an aten graph from
``make_fx``:

- ``ir.programs``    — the K-parameterized registry of engine programs
  (every registered scheme through both round builders, every kernel
  twin), so the walkers below sweep exactly what the port ships;
- ``ir.graph_audit`` — liveness-based peak-memory estimation with
  per-buffer provenance, plus the bf16→f32 silent-promotion audit;
- ``ir.scaling``     — trace each program at K ∈ {4, 16, 64, 256}, fit
  per-buffer and total-peak scaling exponents in K, and gate any buffer
  that scales past its declared budget
  (``src/repro_torch/analysis/scaling.json``).

The reference's ``ir.alias_audit`` has no counterpart: it checks that XLA
honours declared donations, and the port donates nothing.

Everything funnels into the standard ``Finding`` stream, so the CLI's
pragma + baseline machinery applies unchanged.
"""
from repro_torch.analysis.ir.graph_audit import (ProgramAudit, audit_program,
                                                 dtype_promotions,
                                                 run_graph_audit,
                                                 trace_program)
from repro_torch.analysis.ir.programs import EngineProgram, engine_programs
from repro_torch.analysis.ir.scaling import (K_VALUES, run_scaling_gate,
                                             scaling_report, sweep,
                                             write_scaling_json)

__all__ = [
    "EngineProgram", "engine_programs", "ProgramAudit", "audit_program",
    "dtype_promotions", "run_graph_audit", "trace_program", "K_VALUES",
    "scaling_report", "run_scaling_gate", "sweep", "write_scaling_json",
]
