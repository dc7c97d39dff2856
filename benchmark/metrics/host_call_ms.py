"""Host time of one entry call, in ms: from the call to its return (the
prologue graph's copy-in and replay, K1's launch, the DTensor steps on a
mesh), the median over the calls taken in the traced window."""

import statistics


def read(run):
    calls = run.calls_in_trace()
    if not calls:
        return None
    return statistics.median(calls) * 1e3
