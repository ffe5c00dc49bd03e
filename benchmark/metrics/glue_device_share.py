"""glue_device_share (%): the share of the device's kernel, copy and memset
time spent in PyTorch's own kernels and in copies and memsets (tile
extraction and stitching, casts, the finalize, host copies)."""


def read(run):
    t = run.trace
    if t is None or t.n_device == 0 or t.total_s <= 0:
        return None
    return 100.0 * t.glue_s / t.total_s
