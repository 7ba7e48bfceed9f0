"""metacache_tpu — a GPU metagenomic classification framework.

A from-scratch JAX/XLA re-design with the capabilities of
muellan/metacache: windowed min-hash sketching of 2-bit-encoded reads,
feature->location lookup against a reference database in device memory,
contiguous-window candidate generation and ranked-LCA taxonomic assignment.
"""
__version__ = "0.1.0"

from .config import SketchingOptions, ClassificationOptions  # noqa: F401
