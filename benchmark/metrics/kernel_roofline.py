"""kernel_roofline (%): the least time of every convolution and upsample the
window's forwards ran, max(operations / peak, bytes / bandwidth) summed,
as a share of the device time of every kernel that is not PyTorch glue
(the port's kernels and cuDNN's)."""


def read(run):
    t = run.trace
    if t is None or t.n_device == 0 or t.compute_s <= 0:
        return None
    return 100.0 * run.work["bound_s"] / t.compute_s
