"""model_mfu (%): the forwards' convolution operations in the window, each
over the peak of the precision it runs in (from the configuration's layers,
at the shapes the forwards took), as a share of the window's wall time."""


def read(run):
    t = run.trace
    if t is None or t.n_device == 0 or run.window_s <= 0:
        return None
    return 100.0 * run.work["ops_s"] / run.window_s
