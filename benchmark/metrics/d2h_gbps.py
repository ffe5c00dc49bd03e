"""d2h_gbps (GB/s): the output bytes the program copied to the host in the
window (its ``d2h_bytes`` counter) over the summed wall time of its
``iek.d2h`` spans: the copy to pageable memory, its staging and page faults;
the wait for the device sits in ``iek.wait`` before it (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    v = spans.of(run)
    if v is None or v.d2h_bytes is None or v.trace.span_s.get(spans.D2H_SPAN, 0.0) <= 0:
        return None
    return v.d2h_bytes / v.trace.span_s[spans.D2H_SPAN] / 1e9
