"""A run with the timed path broken underneath comes out not correct, and so does the control.

These drive ``harness.run_cell`` on the CPU at a narrow width (the look for
a card is ``run.py``'s, before it): the set-up, a short closed-loop window
and the check against the plain reference, with the program patched.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.common import Numerics  # noqa: E402
from image_enhance_keras_tpu_torch import engine  # noqa: E402
from image_enhance_keras_tpu_torch.models import blocks, didbl_pallas, zoo_int8  # noqa: E402

NARROW = {"didbl": {"features": 16, "n_body53": 2, "n_light": 1, "n_tail53": 1},
          "difv4": {"features": 32, "n_head": 1, "n_mid": 2, "n_tail": 1}}
CELLS = ["didbl-int8-fast512", "difv4-int8-fast512", "didbl-f32-patch"]
SEED = 2**31 + 101


def _cell(name):
    over = {"config": {"model_kwargs": NARROW[name.split("-")[0]]}}
    if "patch" in name:
        over["traffic"] = {"sizes": [[16, 16], [16, 24], [24, 16], [24, 24]], "pool": 1}
        over["workload"] = {"resolver": {"patch": 12, "step": 8, "crop": 2, "tile_chunk": 4}, "warmup": 4}
    else:
        over["traffic"] = {"sizes": [[24, 24]], "pool": 2}
    return harness.load_cell(name, over)


def _run(name):
    return harness.run_cell(_cell(name), SEED, 0.2, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


def _state_unchanged(monkeypatch, name):
    """One kind of block returns its input unchanged."""
    if name.startswith("didbl-int8"):
        monkeypatch.setattr(didbl_pallas, "_light53_i8_xla", lambda x, p: x)
    elif name.startswith("difv4"):
        monkeypatch.setattr(zoo_int8, "_light_i8", lambda x, p, leaky: x)
    else:
        monkeypatch.setattr(blocks.Light53Block, "forward", lambda self, x: x)


def _answer_altered(monkeypatch, name):
    """The uint8 output truncated where the program rounds it."""
    monkeypatch.setattr(engine.SuperResolver, "_finalize_u8",
                        lambda self, y: torch.clamp(torch.floor(y), 0.0, 255.0).to(torch.uint8))


def _half_batch(monkeypatch, name):
    """Half of each tile batch left out of the forward, its outputs zero."""
    orig = engine.SuperResolver._forward_fn

    def forward_fn(self, module=None):
        f = orig(self, module)

        def g(params, b):
            y = f(params, b[: max(1, b.shape[0] // 2)])
            return torch.cat([y, y.new_zeros((b.shape[0] - y.shape[0],) + tuple(y.shape[1:]))])

        return g

    monkeypatch.setattr(engine.SuperResolver, "_forward_fn", forward_fn)


FAULTS = [(c, f) for c in CELLS for f in (_state_unchanged, _answer_altered)] + [("didbl-f32-patch", _half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    r = _run(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference one precision step down (int4 codes; TF32, rounded
    operands on the CPU) in the program's place fails the cell's limit."""
    cell = _cell(name)
    with torch.inference_mode():
        s = harness.setup(cell, SEED, "cpu")
        idx = list(range(len(cell.traffic["sizes"]) * 2))
        own = harness.reference_outputs(cell, s.weights, s.traffic, s.calib_x, idx, "cpu", Numerics())
        ctl = harness.reference_outputs(cell, s.weights, s.traffic, s.calib_x, idx, "cpu",
                                        harness.control_numeric(cell))
    worst = max(harness.compare(ctl[i], own[i])["diff_share"] for i in idx)
    assert worst > cell.workload["limits"]["diff_share"], worst
