"""The device's idle share of the traced window, in %: 1 - the union of
its kernels, copies and sets over the window's length."""


def read(run):
    w = run.trace.window_s
    if w <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / w)
