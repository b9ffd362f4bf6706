"""Static and runtime analysis (counterpart of
``deeplearning4j_tpu/analysis``): configuration validation before any
parameter exists; ``trace_check``, the region monitor for host syncs,
shape drift and captured constants; ``lint``, the AST linter for the
port's hazards (``python -m deeplearning4j_tpu_torch.tools.run_lint``);
and ``callgraph``, the whole-tree call graph its interprocedural rules
(DLT017-019) and the stale-waiver audit stand on."""

from deeplearning4j_tpu_torch.analysis.callgraph import CallGraph, build_graph
from deeplearning4j_tpu_torch.analysis.lint import (LintViolation, StaleWaiver,
                                                    audit_waivers, lint_file,
                                                    lint_paths)
from deeplearning4j_tpu_torch.analysis.trace_check import (TraceHazard, TraceReport,
                                                           trace_check)
from deeplearning4j_tpu_torch.analysis.validation import (ConfigValidationError,
                                                          ValidationIssue,
                                                          validate_graph,
                                                          validate_multilayer)

__all__ = ["ValidationIssue", "ConfigValidationError", "validate_multilayer",
           "validate_graph", "TraceHazard", "TraceReport", "trace_check",
           "LintViolation", "StaleWaiver", "lint_file", "lint_paths", "audit_waivers",
           "CallGraph", "build_graph"]
