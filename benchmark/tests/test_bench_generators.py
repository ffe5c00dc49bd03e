"""The seeded generators: the same seed gives the same images and weights."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, traffic  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

SPEC = {"sizes": [[40, 40], [40, 56]], "pool": 3, "content": "rich", "loop": "closed", "clients": 1}


def test_traffic_is_deterministic_per_seed():
    big = 2**31 + 77
    a, b, c = traffic.Traffic(SPEC, big), traffic.Traffic(SPEC, big), traffic.Traffic(SPEC, big + 1)
    for i in range(12):
        assert np.array_equal(a.image(i), b.image(i))
        assert a.image(i).shape[:2] == tuple(SPEC["sizes"][i % 2])
        assert a.image(i).dtype == np.uint8
    assert any(not np.array_equal(a.image(i), c.image(i)) for i in range(6))
    # every seed sends the same sizes in the same order; the pool repeats after the cycle
    assert [c.image(i).shape for i in range(6)] == [a.image(i).shape for i in range(6)]
    assert np.array_equal(a.image(0), a.image(a.cycle))


def test_weights_are_deterministic_per_seed():
    cell = harness.load_cell("didbl-int8-fast512", {"config": {"model_kwargs": {
        "features": 8, "n_body53": 1, "n_light": 1, "n_tail53": 1}}})
    shapes = harness.reference_module(cell).param_shapes(cell.config)
    w1 = make_weights(shapes, cell.config["init"], 2**31 + 5, "cpu")
    w2 = make_weights(shapes, cell.config["init"], 2**31 + 5, "cpu")
    w3 = make_weights(shapes, cell.config["init"], 2**31 + 6, "cpu")
    k = w1["body53_0"]["conv_a2"]["kernel"]
    assert k.shape == (5, 5, 8, 8)
    assert torch.equal(k, w2["body53_0"]["conv_a2"]["kernel"])
    assert not torch.equal(k, w3["body53_0"]["conv_a2"]["kernel"])
    assert float(k.std()) * (25 * 8) ** 0.5 == __import__("pytest").approx(1.0, abs=0.2)
    assert float(w1["out"]["bias"].abs().sum()) == 0.0
