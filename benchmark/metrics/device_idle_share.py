"""device_idle_share (%): the share of the window in which no kernel, copy or
memset ran on the device: 100 (1 - union of their intervals / window)."""


def read(run):
    t = run.trace
    if t is None or t.n_device == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
