"""Each plain reference against the port's own plain path on the CPU (this test
may import the port; the references may not)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402

NARROW = {"didbl": {"features": 16, "n_body53": 2, "n_light": 1, "n_tail53": 1},
          "difv4": {"features": 32, "n_head": 1, "n_mid": 2, "n_tail": 1}}
FULL_FEW = {"didbl": {"n_body53": 1, "n_light": 1, "n_tail53": 1},
            "difv4": {"n_head": 1, "n_mid": 1, "n_tail": 1}}


def _cell(name, kwargs, sizes):
    over = {"config": {"model_kwargs": kwargs}, "traffic": {"sizes": sizes, "pool": 2}}
    if "patch" in name:
        over["workload"] = {"resolver": {"patch": 12, "step": 8, "crop": 2}}
    return harness.load_cell(name, over)


def _program_vs_reference(cell, seed, n=2):
    with torch.inference_mode():
        s = harness.setup(cell, seed, "cpu")
        outs = {i: s.resolver.upscale(s.traffic.image(i)) for i in range(n)}
    return harness.reference_numbers(cell, s.weights, s.traffic, s.calib_x, outs, "cpu")


@pytest.mark.parametrize("name", ["didbl-int8-fast512", "difv4-int8-fast512"])
def test_int8_reference_equals_the_port_narrow(name):
    cfg = name.split("-")[0]
    got = _program_vs_reference(_cell(name, NARROW[cfg], [[20, 20]]), 2**31 + 3)
    assert got == {"diff_share": 0.0, "max_gap": 0}


def test_f32_patch_reference_equals_the_port_narrow():
    cell = _cell("didbl-f32-patch", NARROW["didbl"], [[16, 16], [16, 24], [24, 16], [24, 24]])
    got = _program_vs_reference(cell, 11, n=4)
    assert got["diff_share"] <= 1e-3 and got["max_gap"] <= 1


@pytest.mark.parametrize("name,hw", [("didbl-int8-fast512", 12), ("difv4-int8-fast512", 8)])
def test_int8_reference_equals_the_port_at_published_width(name, hw):
    cfg = name.split("-")[0]
    got = _program_vs_reference(_cell(name, FULL_FEW[cfg], [[hw, hw]]), 5, n=1)
    assert got == {"diff_share": 0.0, "max_gap": 0}
