"""Per-layer metric readers: ``metrics/<name>.py`` (dots in a name become
underscores) holds ``read(run) -> float | None`` for the metric ``name``
of ``BENCHMARK.json``'s ``per_layer``.  ``run`` is a
``harness.TracedRun``: its ``trace`` (``tracing.Trace``: the kernels and
copies of the traced window, its busy and window seconds, the blocks the
entry took in it), the host records of the entry calls, and the cell.  A
reader that finds nothing to read returns None, and the metric is left
out of the line."""


def is_k1(name: str) -> bool:
    """K1, ``sdft_tpu_torch/kernels/csrc/spectra.cu``'s ``spectra_kernel``."""
    return "spectra_kernel" in name


def is_nccl(name: str) -> bool:
    return "nccl" in name.lower()
