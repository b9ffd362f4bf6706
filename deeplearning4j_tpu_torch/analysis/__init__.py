"""Static and runtime analysis (counterpart of
``deeplearning4j_tpu/analysis``): configuration validation before any
parameter exists, and ``trace_check``, the region monitor for host syncs,
shape drift and captured constants."""

from deeplearning4j_tpu_torch.analysis.trace_check import (TraceHazard, TraceReport,
                                                           trace_check)
from deeplearning4j_tpu_torch.analysis.validation import (ConfigValidationError,
                                                          ValidationIssue,
                                                          validate_graph,
                                                          validate_multilayer)

__all__ = ["ValidationIssue", "ConfigValidationError", "validate_multilayer",
           "validate_graph", "TraceHazard", "TraceReport", "trace_check"]
