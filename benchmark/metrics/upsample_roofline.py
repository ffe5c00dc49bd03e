"""upsample_roofline (%): the roofline least time of the configuration's
``upsample`` layers over the window's forwards (bytes over bandwidth: the
input read once, f^2 times as much written) over the device time launched
inside ``iek.upsample`` spans, K3 (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    v = spans.of(run)
    t = 0.0 if v is None else v.trace.device_s.get(spans.UPSAMPLE_SPAN, 0.0)
    if t <= 0:
        return None
    return 100.0 * v.bound_s["upsample"] / t
