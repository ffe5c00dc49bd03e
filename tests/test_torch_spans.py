"""Stage spans and counters of the port (``utils/profiling.py``) on the CPU.

Spans are ``torch.profiler`` user annotations opened by the engine and the
forwards; without a profiler session ``span`` is one flag read and never
calls ``record_function``.  Under a CPU profiler a tiny ``upscale`` in
patch, fast and split mode nests every engine stage under ``iek.upscale``
and the model's ``iek.block`` / ``iek.upsample`` under ``iek.forward``; the
counters count the plan's chunks, the forwards' input pixels and the
output's bytes; the output is the same with spans on and off.
"""

import contextlib
import json

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from image_enhance_keras_tpu_torch.engine import SuperResolver
from image_enhance_keras_tpu_torch.utils import profiling

TINY = dict(features=8, n_body53=2, n_light=1, n_tail53=1)
H, W = 40, 56
IMG = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
CHUNK = 3
STRIPE = 4
MODES = ("patch", "fast", "split")


@pytest.fixture(scope="module")
def resolvers():
    out = {}
    for mode in MODES:
        r = SuperResolver(model="didbl", model_kwargs=TINY, device="cpu", patch=24, step=16, crop=4, mode=mode,
                          split_tile=STRIPE)
        r.tile_chunk = CHUNK
        out[mode] = r
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return prof, result


def _spans(prof, tmp_path) -> list[tuple[float, float, str]]:
    """The ``iek.*`` spans of the exported Chrome trace: (start, end, name)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("iek.")]


def _parents(spans) -> list[tuple[str, str | None]]:
    """(name, the name of the shortest other span that encloses it) of each span."""
    out = []
    for i, (s, t, name) in enumerate(spans):
        outer = [(t1 - s1, n1) for j, (s1, t1, n1) in enumerate(spans) if j != i and s1 <= s and t <= t1]
        out.append((name, min(outer)[1] if outer else None))
    return out


def test_span_without_profiler_never_records(monkeypatch, resolvers):
    calls = []
    monkeypatch.setattr(profiling, "record_function", lambda name: calls.append(name) or contextlib.nullcontext())
    assert not profiling.tracing()
    for _ in range(100):
        with profiling.span(profiling.SPAN_BLOCK):
            pass
    for r in resolvers.values():
        r.upscale(IMG)
    assert calls == []
    _profiled(lambda: resolvers["fast"].upscale(IMG))
    assert calls[0] == profiling.SPAN_UPSCALE and profiling.SPAN_BLOCK in calls


@pytest.mark.parametrize("mode", MODES)
def test_trace_nests_stages(resolvers, tmp_path, mode):
    prof, _ = _profiled(lambda: resolvers[mode].upscale(IMG))
    pairs = _parents(_spans(prof, tmp_path))
    assert [n for n, p in pairs if p is None] == [profiling.SPAN_UPSCALE]
    stages = {n for n, p in pairs if p == profiling.SPAN_UPSCALE}
    want = {profiling.SPAN_H2D, profiling.SPAN_FORWARD, profiling.SPAN_STITCH, profiling.SPAN_FINALIZE,
            profiling.SPAN_D2H} | ({profiling.SPAN_EXTRACT} if mode == "patch" else set())
    assert stages == want  # no iek.wait: the CPU has no stream to wait for
    for name in (profiling.SPAN_BLOCK, profiling.SPAN_UPSAMPLE):
        assert {p for n, p in pairs if n == name} == {profiling.SPAN_FORWARD}
    n_forward = sum(n == profiling.SPAN_FORWARD for n, _ in pairs)
    n_stripes = -(-H // STRIPE)
    assert n_forward == {"patch": 4, "fast": 1, "split": 1 + n_stripes}[mode]
    # didbl: the body's run of blocks and the tail's; split runs the tail once a stripe
    assert sum(n == profiling.SPAN_BLOCK for n, _ in pairs) == {"patch": 8, "fast": 2, "split": 1 + n_stripes}[mode]


@pytest.mark.parametrize("mode", MODES)
def test_counters_count_the_plan(resolvers, mode):
    r = resolvers[mode]
    before = profiling.counters()
    out = r.upscale(IMG)
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    n_tiles = r.plan_for(H, W).n_tiles
    calls = {"patch": -(-n_tiles // CHUNK), "fast": 1, "split": 1 + -(-H // STRIPE)}[mode]
    pixels = n_tiles * 24 * 24 if mode == "patch" else H * W
    assert delta == {"images": 1, "forward_calls": calls, "forward_pixels": pixels, "d2h_bytes": out.nbytes,
                     "hand_launches": 0}
    assert out.nbytes == 4 * H * 4 * W * 3


@pytest.mark.parametrize("mode", MODES)
def test_output_same_with_spans_on_and_off(resolvers, mode):
    off = resolvers[mode].upscale(IMG)
    _, on = _profiled(lambda: resolvers[mode].upscale(IMG))
    np.testing.assert_array_equal(on, off)


def test_stage_self_times_add_up_to_the_request(resolvers):
    """Each stage's self time is its span less its child spans, so the self
    times of one request sum to its root span; a CPU session has no device time."""
    prof, _ = _profiled(lambda: resolvers["patch"].upscale(IMG))
    root = [e for e in prof.events() if e.name == profiling.SPAN_UPSCALE]
    assert len(root) == 1
    self_ms = profiling.stage_self_ms(prof)
    assert set(self_ms) >= {profiling.SPAN_UPSCALE, profiling.SPAN_FORWARD, profiling.SPAN_BLOCK}
    assert all(v >= 0 for v in self_ms.values())
    total = (root[0].time_range.end - root[0].time_range.start) / 1e3
    assert sum(self_ms.values()) == pytest.approx(total, rel=1e-6)
    assert profiling.device_busy_ms(prof) == 0.0


def test_hand_launches_gathers_every_counting_wrapper():
    """Every function of ``ops/cuda`` that counts in ``.launches`` is in the
    one list ``counters()`` sums."""
    import importlib
    import pkgutil

    import image_enhance_keras_tpu_torch.ops.cuda as pkg

    listed = set(map(id, pkg.counted_wrappers()))
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and hasattr(obj, "launches"):
                assert id(obj) in listed, f"{info.name}.{name} counts launches but is not listed"
    f = pkg.counted_wrappers()[0]
    before = profiling.counters()["hand_launches"]
    f.launches += 2
    try:
        assert profiling.counters()["hand_launches"] == before + 2
    finally:
        f.launches -= 2
