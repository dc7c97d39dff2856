"""CPU tests of the benchmark harness (``python -m pytest benchmark/tests``
from the repository root); the repository's own suite under ``tests/``
does not collect them."""
