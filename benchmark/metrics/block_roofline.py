"""block_roofline (%): the roofline least time of the configuration's
``block`` layers over the window's forwards, max(operations / peak, bytes /
bandwidth) a layer as ``kernel_roofline`` counts it, over the device time
launched inside ``iek.block`` spans: the residual blocks alone, apart from
the engine's glue and the other layers (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    v = spans.of(run)
    t = 0.0 if v is None else v.trace.device_s.get(spans.BLOCK_SPAN, 0.0)
    if t <= 0:
        return None
    return 100.0 * v.bound_s["block"] / t
