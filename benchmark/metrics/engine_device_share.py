"""engine_device_share (%): the device time of the kernels, copies and
memsets launched inside an engine stage (every ``iek.*`` span but
``iek.forward`` and what it encloses) over all device time in the window:
the span-based twin of ``glue_device_share`` (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    v = spans.of(run)
    if v is None or v.trace.device_total_s <= 0:
        return None
    return 100.0 * v.trace.engine_device_s / v.trace.device_total_s
