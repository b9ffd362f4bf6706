"""Static analysis of configurations (counterpart of
``deeplearning4j_tpu/analysis``): validation before any parameter
exists."""

from deeplearning4j_tpu_torch.analysis.validation import (ConfigValidationError,
                                                          ValidationIssue,
                                                          validate_graph,
                                                          validate_multilayer)

__all__ = ["ValidationIssue", "ConfigValidationError", "validate_multilayer",
           "validate_graph"]
