"""The port's exported serving artifacts (``runtime/export.py``, ``cli/export_model.py``) against JAX's.

``export_forward`` and ``export_pipeline`` round trips as JAX's
``tests/test_engine_e2e.py`` runs them (xla, int8, split, back-projection),
on the narrow didbl (features 8, one block of each kind) and a 24x20 image.
Tolerances: each loaded artifact equals ``resolver.upscale`` byte for byte;
against JAX's ``load_forward`` of its own export (a jitted program, which
contracts the int8 dequant into fused multiply-adds where the port follows
JAX op by op) the int8 artifacts, under the s32 accumulator, are within 3
levels on 5% of the values (the bound ``tests/test_torch_engine.py`` holds
between int8 forwards), the float32 ones, whose convolutions sum in another
order, within 1 level on 0.1%.  The program reaches every kernel as an ``iek::`` op,
and loads in a process that imports no model and no engine.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli import export_model as jax_cli
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu.models.didbl import DifvdsrDouble as FlaxDidbl
from image_enhance_keras_tpu.runtime import export as jax_export
from image_enhance_keras_tpu_torch.cli import export_model as port_cli
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble
from image_enhance_keras_tpu_torch.models.weights import flatten_params
from image_enhance_keras_tpu_torch.runtime import export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(features=8, n_body53=1, n_light=1, n_tail53=1)
HW = (24, 20)
MAX_DIFF, MAX_FRAC = 1, 1e-3
INT8_MAX_DIFF, INT8_MAX_FRAC = 3, 0.05
#: name -> (engine options, export function, iek:: nodes of the program); JAX's export of
#: each is compared too, but the 2-D tiled int8 split's (a long compile on the CPU)
CASES = {
    "xla_forward": (dict(mode="fast"), "export_forward", {"upsample_phase_tf1": 1}),
    "xla_patch": (dict(mode="patch", patch=24, step=16), "export_pipeline", {"upsample_phase_tf1": 1}),
    "int8_fast": (dict(mode="fast", forward="int8"), "export_pipeline",
                  {"light53_int8_xla": 2, "light_int8_xla": 1, "upsample_phase_tf1": 1}),
    "split": (dict(mode="split", split_tile=8), "export_pipeline", {"upsample_phase_tf1": 3}),
    "int8_split2d": (dict(mode="split", forward="int8", split_tile=8, split_tile_w=8), "export_pipeline",
                     {"light53_int8_xla": 3, "light_int8_xla": 1, "upsample_phase_tf1": 2}),
    "back_projection": (dict(mode="fast", back_projection=2), "export_pipeline", {"upsample_phase_tf1": 1}),
}


@pytest.fixture(scope="module")
def tiny():
    module = FlaxDidbl(**NARROW)
    params = module.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 3)))["params"]
    img = np.random.default_rng(17).integers(0, 256, (*HW, 3), dtype=np.uint8)
    return module, jax.tree_util.tree_map(np.asarray, params), img


def _resolvers(tiny, **kw):
    module, pn, _ = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    jr = jax_engine.SuperResolver(params=jax.tree_util.tree_map(jnp.asarray, pn), module_and_spec=(module, jspec),
                                  **kw)
    pmod = DifvdsrDouble(**NARROW)
    pspec = port_zoo.ModelSpec("didbl", lambda **k: pmod, 4, False, "tiny", None)
    pr = port_engine.SuperResolver(params=pn, module_and_spec=(pmod, pspec), device="cpu", **kw)
    # int8: both calibrate on the test image itself (the engines' first-frame calibration input)
    calib = np.asarray(tiny[2], np.float32)[None] / np.float32(255.0)
    jr._calib_x, pr._calib_x = jnp.asarray(calib), torch.from_numpy(calib)
    return jr, pr


def _iek_nodes(program) -> dict:
    counts: dict = {}
    for n in program.graph.nodes:
        if n.op == "call_function" and getattr(n.target, "namespace", None) == "iek":
            name = n.target.name().split("::")[1].split(".")[0]
            counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_roundtrip_matches_upscale_and_jax(tiny, tmp_path, monkeypatch, case):
    kw, fn_name, nodes = CASES[case]
    if "forward" in kw:
        monkeypatch.setenv("IEK_INT8_ACC", "s32")
    img = tiny[2]
    jr, pr = _resolvers(tiny, **kw)
    path = str(tmp_path / "a.iekx")
    nbytes = getattr(export, fn_name)(pr, HW, path)
    assert nbytes == os.path.getsize(path) and open(path, "rb").read(8) == b"IEKX0001"
    fn = export.load_forward(path)
    got = fn(img)
    assert got.shape == (96, 80, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, pr.upscale(img))
    assert _iek_nodes(fn.program) == nodes
    if case == "int8_split2d":
        return
    jpath = str(tmp_path / "jax.iekx")
    getattr(jax_export, fn_name)(jr, HW, jpath)
    want = np.asarray(jax_export.load_forward(jpath)(img))
    most, frac = (INT8_MAX_DIFF, INT8_MAX_FRAC) if "forward" in kw else (MAX_DIFF, MAX_FRAC)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= most and (d > 0).mean() <= frac, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def int8_artifact(tiny, tmp_path_factory):
    """The int8 fast program under the default (bf16) accumulator: its path and resolver."""
    _, pr = _resolvers(tiny, mode="fast", forward="int8")
    path = str(tmp_path_factory.mktemp("int8") / "b.iekx")
    export.export_pipeline(pr, HW, path)
    return path, pr


def test_int8_bf16_accumulator_artifact_matches_upscale(tiny, int8_artifact):
    path, pr = int8_artifact
    np.testing.assert_array_equal(export.load_forward(path)(tiny[2]), pr.upscale(tiny[2]))


def test_self_ensemble_is_warned_and_not_baked(tiny, tmp_path, caplog):
    import logging

    _, pr = _resolvers(tiny, mode="fast", self_ensemble=True)
    logger = logging.getLogger("image_enhance_keras_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        export.export_pipeline(pr, HW, str(tmp_path / "se.iekx"))
    finally:
        logger.removeHandler(caplog.handler)
    assert any("SINGLE-pass" in r.getMessage() for r in caplog.records)
    pr.self_ensemble = False
    np.testing.assert_array_equal(export.load_forward(str(tmp_path / "se.iekx"))(tiny[2]), pr.upscale(tiny[2]))


def test_loads_without_models_or_engine(tiny, int8_artifact, tmp_path):
    path, pr = int8_artifact
    np.save(tmp_path / "img.npy", tiny[2])
    np.save(tmp_path / "want.npy", pr.upscale(tiny[2]))
    code = (
        "import sys, numpy as np\n"
        "from image_enhance_keras_tpu_torch.runtime.export import load_forward\n"
        "fn = load_forward(sys.argv[1])\n"
        "ok = np.array_equal(fn(np.load(sys.argv[2])), np.load(sys.argv[3]))\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('image_enhance_keras_tpu_torch.models',\n"
        "             'image_enhance_keras_tpu_torch.engine')) or m.split('.')[0] in ('jax', 'image_enhance_keras_tpu'))\n"
        "print(ok, bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, path, str(tmp_path / "img.npy"), str(tmp_path / "want.npy")],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "True []"


def test_bad_magic_raises(tmp_path):
    bad = tmp_path / "bad.iekx"
    bad.write_bytes(b"NOTIEKX0" + b"\0" * 32)
    with pytest.raises(ValueError, match="not an IEKX artifact"):
        export.load_forward(str(bad))


def test_cli_flags_match_jax():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type)
                for a in parser._actions if a.dest != "help"}

    ours, theirs = flags(port_cli.build_parser()), flags(jax_cli.build_parser())
    assert ours.pop("device") == (("--device",), "cuda", ["cuda", "cpu"], None, None)
    assert ours == theirs


def test_cli_writes_the_artifact_and_jax_summary(tiny, tmp_path, monkeypatch, capsys):
    module, pn, img = tiny
    jspec = jax_zoo.ModelSpec("didbl", lambda **k: module, 4, False, "tiny", None)
    monkeypatch.setattr(jax_engine, "get_model", lambda name, dtype=None, **kw: (module, jspec))
    pspec = port_zoo.ModelSpec("didbl", lambda **k: DifvdsrDouble(**NARROW), 4, False, "tiny", None)
    monkeypatch.setattr(port_engine, "get_model", lambda name, dtype=None, **kw: (pspec.make(), pspec))
    npz = str(tmp_path / "tiny.npz")
    np.savez(npz, **flatten_params(pn))
    common = ["--weights", npz, "--dtype", "float32", "--hw", "24", "20", "--mode", "split", "--split-tile", "8"]
    assert port_cli.main([str(tmp_path / "p.iekx"), *common, "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert jax_cli.main([str(tmp_path / "j.iekx"), *common]) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    strip = lambda line: line.split(":", 1)[1].split("MB", 1)[1]  # noqa: E731 - the sizes differ
    assert ours.startswith(f"wrote {tmp_path / 'p.iekx'}: ") and strip(ours) == strip(theirs)
    assert strip(ours) == " (didbl 24x20 float32 xla split tile 8)"
    _, pr = _resolvers(tiny, mode="split", split_tile=8)
    np.testing.assert_array_equal(export.load_forward(str(tmp_path / "p.iekx"))(img), pr.upscale(img))
