"""On the card: a short run of each cell comes out correct with every metric it reports.

Marked ``cuda``; skips without a card.  Run on the card with
``python -m pytest -m cuda benchmark/tests/test_bench_card.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["didbl-int8-fast512", "difv4-int8-fast512", "didbl-f32-patch"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.load_cell(name)
    r = harness.run_cell(cell, 2**31 + 9, 2.0, trace, "cuda")
    assert r["correct"], r["checks"]
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert all(0 <= m["value"] <= 100 for m in r["metrics"].values())
