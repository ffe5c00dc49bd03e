"""Operation counts of the configurations and the patch cell's tile plan."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import pytest  # noqa: E402

from benchmark import counting, harness  # noqa: E402
from benchmark.reference.common import plan_tiles  # noqa: E402


@pytest.mark.parametrize("name,mflop", [("didbl", 110.6), ("difv4", 429.6)])
@pytest.mark.parametrize("forward", ["xla", "int8"])
def test_mflop_per_lr_pixel(name, mflop, forward):
    cell = next(c for c in ("didbl-int8-fast512", "difv4-int8-fast512") if c.startswith(name))
    cfg = harness.load_cell(cell).config
    assert counting.mflop_per_lr_pixel(cfg, forward) == pytest.approx(mflop, abs=0.05)


def test_int8_image_at_peak():
    """didbl int8 at 512x512: 2.9e13 int8 operations, 14.6 ms at 1,979 TOP/s."""
    cfg = harness.load_cell("didbl-int8-fast512").config
    w = counting.image_work(cfg, "int8", 512 * 512, counting.load_peaks())
    assert w["ops"]["int8"] == pytest.approx(2.897e13, rel=1e-3)
    assert 1e3 * w["ops"]["int8"] / 1.979e15 == pytest.approx(14.64, abs=0.01)
    assert w["bound_s"] > w["ops_s"]  # level1, out and the x4 are bound by bytes


def test_patch_cycle_tiles():
    cell = harness.load_cell("didbl-f32-patch")
    counts = [plan_tiles(h, w).n_tiles for h, w in cell.traffic["sizes"]]
    assert counts == [25, 35, 35, 49]
    px = [counting.forward_pixels(h, w, "patch") for h, w in cell.traffic["sizes"]]
    assert px == [n * 96 * 96 for n in counts]


def test_plan_matches_program():
    from image_enhance_keras_tpu_torch.tiling.tiles import plan_tiles as program_plan

    for h, w in [(256, 256), (256, 384), (384, 256), (384, 384), (17, 93), (128, 200)]:
        a, b = plan_tiles(h, w), program_plan(h, w)
        assert (a.ph, a.pw, a.cnt_h, a.cnt_w) == (b.padded_h, b.padded_w, b.cnt_h, b.cnt_w)
