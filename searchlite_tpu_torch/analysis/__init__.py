"""Text analysis: tokenizers, token filters, analyzer registry.

Index-time and query-time analysis must be identical for search to work;
this package is pure host-side code (tokenization is inherently
byte-level and stays off the TPU — the device consumes its integer
output).
"""

from searchlite_tpu_torch.analysis.analyzer import (  # noqa: F401
    Analyzer,
    AnalyzerRegistry,
    Token,
)
