"""engine_idle_share (%): the device's idle time while the host's innermost
``iek.*`` span is an engine stage (``iek.upscale``'s own time, ``iek.h2d``,
``iek.extract``, ``iek.stitch``, ``iek.finalize``, ``iek.wait``,
``iek.d2h``), over the window (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    v = spans.of(run)
    if v is None or v.trace.window_s <= 0:
        return None
    return 100.0 * v.trace.engine_idle_s / v.trace.window_s
