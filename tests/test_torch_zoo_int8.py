"""The zoo's ``--forward int8`` in the port against the JAX package on the CPU.

JAX runs these convolutions as XLA ops over quantized tensors; the port
runs each on X4 (``ops/cuda/int8_conv.py``), whose plain version runs
here.  The reference is JAX run op by op (``jax.disable_jit()``), as in
tests/test_torch_int8_xla.py: on JAX's quantized tree (carried over with
``params_from_numpy``) the port's forwards, their body / tail parts and
the engine are bit- (float) or byte- (uint8) equal to it under the bf16
and s32 accumulators.  The port's own calibration agrees with JAX's within
relative 1e-5 (float32 sums in another order); given the same scales its
weight codes and scales are bit-equal.  Narrow models (features 16, one
or two blocks a tower).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_enhance_keras_tpu.engine as jax_engine
import image_enhance_keras_tpu.models.zoo_int8 as jax_zi
import image_enhance_keras_tpu_torch.engine as port_engine
from image_enhance_keras_tpu.cli.main_dirpath import main as jax_main
from image_enhance_keras_tpu.models import didbl_pallas as jax_dp
from image_enhance_keras_tpu.models import zoo as jax_zoo
from image_enhance_keras_tpu_torch.cli.main_dirpath import main as port_main
from image_enhance_keras_tpu_torch.data.io import _bmp_write, imread
from image_enhance_keras_tpu_torch.models import didbl_pallas as dp
from image_enhance_keras_tpu_torch.models import zoo as port_zoo
from image_enhance_keras_tpu_torch.models import zoo_int8 as zi
from image_enhance_keras_tpu_torch.models.weights import flatten_params, params_from_numpy
from image_enhance_keras_tpu_torch.ops.cuda import int8_conv
from tests.test_torch_zoo import ZOO

ACT_RTOL = 1e-5
ACCS = ["bf16", "s32"]


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) else t.float().numpy()


def _support(name, which):
    cfg, fcls, pcls, _, _ = ZOO[name]
    return jax_zi.int8_support(fcls(**cfg)) if which == "jax" else zi.int8_support(pcls(**cfg))


@pytest.fixture(scope="module")
def zoo():
    """name -> (flax params as numpy, calibration batch, JAX's quantized tree
    (op by op), the same as the port's tensors, the port's own quantized tree)."""
    out = {}
    for i, (name, (cfg, fcls, pcls, _, _)) in enumerate(ZOO.items()):
        module = fcls(**cfg)
        params = module.init(jax.random.PRNGKey(11 + i), jnp.zeros((1, 16, 16, 3)))["params"]
        pn = jax.tree_util.tree_map(np.asarray, params)
        calib = np.random.default_rng(9 + i).random((2, 20, 20, 3)).astype(np.float32)
        with jax.disable_jit():
            jq = _support(name, "jax")[0](params, jnp.asarray(calib))
        jq = jax.tree_util.tree_map(np.asarray, jq)
        own = _support(name, "port")[0](params_from_numpy(pn), torch.from_numpy(calib))
        out[name] = (pn, calib, jq, params_from_numpy(jq), own)
    return out


@pytest.mark.parametrize("name", sorted(ZOO))
def test_quantized_tree_matches_jax(zoo, name):
    """Calibration within relative 1e-5; folded codes may flip at a .5 (1e-3 of them, by 1)."""
    _, _, jq, _, own = zoo[name]
    want, got = flatten_params(jq), flatten_params(own)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key].numpy()
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("q", "qf"):
            assert g.dtype == np.int8
            assert (g != w).mean() <= 1e-3 and np.abs(g.astype(int) - w).max() <= 1, key
        else:
            np.testing.assert_allclose(g, w, rtol=ACT_RTOL, err_msg=key)


@pytest.mark.parametrize("name", ["difv4", "difvdsr"])
def test_folded_codes_bit_equal_on_jax_scales(zoo, name):
    """Given JAX's calibrated scales, _qfold gives JAX's codes and scales bit for bit."""
    pn, _, jq, _, _ = zoo[name]
    blk = "head_0" if name == "difv4" else "diff_0"
    for conv, s in (("conv_a", "x"), ("conv_b", "t" if name == "difv4" else "t1")):
        got = zi._qfold(params_from_numpy(pn[blk][conv]), torch.from_numpy(jq[blk]["actc"][s]))
        np.testing.assert_array_equal(got["qf"].numpy(), jq[blk][conv]["qf"])
        np.testing.assert_array_equal(got["sf"].numpy(), jq[blk][conv]["sf"])


def _x(seed, hw=(12, 10)):
    return np.random.default_rng(seed).random((2, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_forward_bit_equal_eager_jax(zoo, monkeypatch, name, acc):
    _, _, jq, qp, _ = zoo[name]
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    x = _x(1)
    with jax.disable_jit():
        want = _support(name, "jax")[1](jq, jnp.asarray(x))
    got = _support(name, "port")[1](qp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("name", ["didbl_subpixel", "difv4", "difv4_x2"])
def test_body_and_tail_bit_equal_eager_jax(zoo, monkeypatch, name, acc, dynamic):
    """The split parts; ``dynamic``: the subpixel head and the tail blocks on per-sample scales."""
    if dynamic and name != "didbl_subpixel":
        pytest.skip("int8_dynamic_tail is the didbl family's (both packages refuse it here)")
    _, _, jq, qp, _ = zoo[name]
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    x = _x(2)
    js, ps = _support(name, "jax"), _support(name, "port")
    with jax.disable_jit():
        hb = js[2](jq, jnp.asarray(x))
        if dynamic:
            want = jax_dp.apply_didbl_int8_xla_tail(jq, hb, n_tail53=1, dynamic=True, upsampler="subpixel")
        else:
            want = js[3](jq, hb)
    got_h = ps[2](qp, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got_h), _np(hb))
    if dynamic:
        got = dp.apply_didbl_int8_xla_tail(qp, got_h, n_tail53=1, dynamic=True, upsampler="subpixel")
    else:
        got = ps[3](qp, got_h)
    np.testing.assert_array_equal(got.numpy(), _np(want))


#: X4's plain version against JAX's ops: (C_in, C_out, x dtype)
X4_CASES = [(32, 64, "bfloat16"), (32, 64, "float32"), (64, 192, "float32")]


@pytest.mark.parametrize("act", [None, "relu", 0.2])
@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("case", X4_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_x4_plain_bit_equal_eager_jax(monkeypatch, case, acc, act):
    """act(_deqf(_qconv_xla(_quant_c(x, s), qf), p)) and the dynamic _deq_dyn form."""
    cin, cout, dtype = case
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    rng = np.random.default_rng(cin + cout)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32) * np.exp(rng.normal(size=cin)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    w = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
    s_in = (np.abs(x).max(axis=(0, 1, 2)) / 100.0).astype(np.float32)
    with jax.disable_jit():
        p = jax_zi._qfold({"kernel": w, "bias": rng.normal(size=cout).astype(np.float32) * 0.01}, s_in)
        from image_enhance_keras_tpu.ops.pallas.int8_blocks import quantize_weights_per_channel

        q, s = quantize_weights_per_channel(w)
        p.update(q=q, s=s)
        y = jax_dp._deqf(jax_dp._qconv_xla(jax_dp._quant_c(xj, jnp.asarray(s_in)), p["qf"]), p)
        xq, sx = jax_dp._quant_dyn_sample(xj)
        yd = jax_dp._deq_dyn(jax_dp._qconv_xla(xq, p["q"]), p, sx)
        acts = [v if act is None else jax_zi._act(v, None if act == "relu" else act) for v in (y, yd)]
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    got = int8_conv.int8_conv3(xt, t["qf"], t["sf"], t["bias"], torch.from_numpy(s_in), acc=acc, act=act)
    got_d = int8_conv.int8_conv3_dyn(xt, t["q"], t["s"], t["bias"], acc=acc, act=act)
    np.testing.assert_array_equal(got.numpy(), _np(acts[0]))
    np.testing.assert_array_equal(got_d.numpy(), _np(acts[1]))


#: X4's block forms against JAX's blocks: (channels, x dtype), under every accumulator
BLOCK_CASES = [(32, "bfloat16"), (64, "float32"), (96, "bfloat16")]
ACCS3 = ["bf16", "s32", "f32"]


def _block_case(c, dtype, names, seed):
    """x (as JAX's and the port's), the float32 params of the block's convs (numpy)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 9, 11, c)) * np.exp(rng.normal(size=c) * 0.5)).astype(np.float32)
    convs = {n: {"kernel": (rng.normal(size=(3, 3, c, c)) * (2.0 / (9 * c)) ** 0.5).astype(np.float32),
                 "bias": (rng.normal(size=c) * 0.02).astype(np.float32)} for n in names}
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return xj, torch.from_numpy(x).to(getattr(torch, dtype)), convs


def _scale(t):
    """A calibration-like scale of t: its channels' abs-max / 100 (clips a few codes)."""
    return (np.maximum(np.abs(_np(t)).max(axis=(0, 1, 2)), 1e-6) / np.float32(100.0)).astype(np.float32)


def _jq_conv(convs, name, v, s, act=False):
    """JAX's folded conv ``name`` at the scales s and its dequantized output
    (with JAX's ``_act`` unless act is False)."""
    p = jax_zi._qfold(convs[name], s)
    y = jax_dp._deqf(jax_dp._qconv_xla(jax_dp._quant_c(v, jnp.asarray(s)), p["qf"]), p)
    return p, (y if act is False else jax_zi._act(y, act))


@pytest.mark.parametrize("leaky", [None, jax_zi._DIFV4_LEAKY_HEAD], ids=["relu", "leaky"])
@pytest.mark.parametrize("acc", ACCS3)
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_light_block_forms_bit_equal_eager_jax(monkeypatch, case, acc, leaky):
    """A LightBlock on X4's forms, plain versions: conv_a's codes are JAX's
    _quant_c(t, s_t), conv_b with the combine is JAX's _light_i8, op by op."""
    c, dtype = case
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    xj, xt, convs = _block_case(c, dtype, ("conv_a", "conv_b"), c + len(acc))
    with jax.disable_jit():
        s_x = _scale(xj)
        _, t = _jq_conv(convs, "conv_a", xj, s_x, leaky)
        p = jax_zi._quantize_light(convs, {"x": jnp.asarray(s_x), "t": jnp.asarray(_scale(t))})
        tq = jax_dp._quant_c(t, p["actc"]["t"])
        want = jax_zi._light_i8(xj, p, leaky)
    qp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p))
    a, b = qp["conv_a"], qp["conv_b"]
    got_tq = int8_conv.int8_conv3_codes(xt, a["qf"], a["sf"], a["bias"], qp["actc"]["x"], qp["actc"]["t"], acc=acc,
                                        act=zi._relu_or_leaky(leaky))
    np.testing.assert_array_equal(got_tq.numpy(), np.asarray(tq))
    got = int8_conv.int8_conv3_light(got_tq, b["qf"], b["sf"], b["bias"], xt, acc=acc)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(zi._light_i8(xt, qp, leaky)), _np(want))


@pytest.mark.parametrize("acc", ACCS3)
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_diff_block_forms_bit_equal_eager_jax(monkeypatch, case, acc):
    """A DiffBlock on X4's four forms, plain versions, against JAX op by op:
    the codes of t1, d and u1 (JAX's _quant_c), t, and _diff_i8's output."""
    c, dtype = case
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    xj, xt, convs = _block_case(c, dtype, ("conv_a", "conv_b", "conv_c", "conv_d"), 2 * c + len(acc))
    with jax.disable_jit():
        sc, p = {"x": _scale(xj)}, {}
        p["conv_a"], t1 = _jq_conv(convs, "conv_a", xj, sc["x"], None)
        sc["t1"] = _scale(t1)
        p["conv_b"], t = _jq_conv(convs, "conv_b", t1, sc["t1"])
        d = t - xj.astype(jnp.float32)
        sc["d"] = _scale(d)
        p["conv_c"], u1 = _jq_conv(convs, "conv_c", d, sc["d"], jax_zi._DSR_LEAKY)
        sc["u1"] = _scale(u1)
        p["conv_d"] = jax_zi._qfold(convs["conv_d"], sc["u1"])
        p["actc"] = {k: jnp.asarray(v) for k, v in sc.items()}
        codes = [np.asarray(jax_dp._quant_c(v, p["actc"][k])) for v, k in ((t1, "t1"), (d, "d"), (u1, "u1"))]
        want = jax_zi._diff_i8(xj, p)
    qp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p))
    s = qp["actc"]

    def w(name):
        return qp[name]["qf"], qp[name]["sf"], qp[name]["bias"]

    t1q = int8_conv.int8_conv3_codes(xt, *w("conv_a"), s["x"], s["t1"], acc=acc, act="relu")
    got_t, dq = int8_conv.int8_conv3_diff_b(t1q, *w("conv_b"), xt, s["d"], acc=acc)
    u1q = int8_conv.int8_conv3_codes(dq, *w("conv_c"), None, s["u1"], acc=acc, act=zi._DSR_LEAKY)
    got = int8_conv.int8_conv3_diff_d(u1q, *w("conv_d"), xt, got_t, acc=acc)
    for g, want_codes in zip((t1q, dq, u1q), codes):
        np.testing.assert_array_equal(g.numpy(), want_codes)
    np.testing.assert_array_equal(got_t.numpy(), _np(t))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(zi._diff_i8(xt, qp)), _np(want))


def test_x4_wrapper_checks_its_arguments():
    x = torch.zeros(1, 4, 4, 32)
    q = torch.zeros(3, 3, 32, 64, dtype=torch.int8)
    v = torch.zeros(64)
    with pytest.raises(ValueError, match="accumulator"):
        int8_conv.int8_conv3(x, q, v, v, torch.ones(32), acc="s16")
    with pytest.raises(ValueError, match="act must be"):
        int8_conv.int8_conv3(x, q, v, v, torch.ones(32), act="gelu")
    with pytest.raises(ValueError, match="weights must be int8"):
        int8_conv.int8_conv3(x, q[:, :, :16], v, v, torch.ones(32))
    with pytest.raises(ValueError, match="float32"):
        int8_conv.int8_conv3_dyn(x, q, v[:32], v)
    with pytest.raises(ValueError, match="int8 codes without s_in"):
        int8_conv.int8_conv3_codes(x, q, v, v, None, v)
    with pytest.raises(ValueError, match="int8 codes of the conv's input"):
        int8_conv.int8_conv3_light(x, q, v, v, torch.zeros(1, 4, 4, 64))
    with pytest.raises(ValueError, match="block's tensors"):
        int8_conv.int8_conv3_diff_d(x.to(torch.int8), q, v, v, torch.zeros(1, 4, 4, 64), torch.zeros(1, 4, 4, 32))
    packed = int8_conv.packed(torch.arange(9 * 64 * 192, dtype=torch.int64).remainder(127).to(torch.int8)
                              .reshape(3, 3, 64, 192))
    assert tuple(packed.shape) == (9, 2, 2, 2, 96, 16)  # C_out 192: two column blocks of 96


def test_int8_support_of_every_model():
    for name in ZOO:
        sup = _support(name, "port")
        assert len(sup) == 4 and callable(sup[0]) and callable(sup[1])
        assert (sup[2] is None) == (name == "difvdsr")
    assert zi.int8_support(torch.nn.Identity()) is None


# -- the engine -----------------------------------------------------------------

MODES = {"patch": dict(mode="patch"), "fast": dict(mode="fast"), "split": dict(mode="split", split_tile=4),
         "split2d": dict(mode="split", split_tile=8, split_tile_w=8)}


def _engines(zoo, name, attrs=None, **kw):
    """The JAX and the port engine on the narrow model, both with JAX's quantized tree."""
    pn, _, jq, qp, _ = zoo[name]
    cfg, fcls, pcls, scale, pre = ZOO[name]
    jmod, pmod = fcls(**cfg), pcls(**cfg)
    jr = jax_engine.SuperResolver(model=name, params=jax.tree_util.tree_map(jnp.asarray, pn), patch=24, step=16,
                                  module_and_spec=(jmod, jax_zoo.ModelSpec(name, None, scale, pre, "narrow", None)),
                                  forward="int8", **kw)
    pr = port_engine.SuperResolver(model=name, params=pn, patch=24, step=16, device="cpu", forward="int8",
                                   module_and_spec=(pmod, port_zoo.ModelSpec(name, None, scale, pre, "narrow", None)),
                                   **kw)
    jr._qparams, pr._qparams = jq, qp
    for k, v in (attrs or {}).items():
        setattr(jr, k, v)
        setattr(pr, k, v)
    return jr, pr


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(ZOO))
def test_engine_byte_equal_eager_jax(zoo, monkeypatch, name, mode, acc):
    """Every mode JAX gives the model (difvdsr's split falls back to patch in both)."""
    monkeypatch.setenv("IEK_INT8_ACC", acc)
    img = np.random.default_rng(13).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    jr, pr = _engines(zoo, name, **MODES[mode])
    with jax.disable_jit():
        want = np.asarray(jr.upscale(img))
    got = pr.upscale(img)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


#: the ``iek::`` ops of X4's block forms an int8 forward of the model runs
ZOO_BLOCK_OPS = {"difv4": {"int8_conv3_codes", "int8_conv3_light"},
                 "difvdsr": {"int8_conv3_codes", "int8_conv3_diff_b", "int8_conv3_diff_d"}}


@pytest.mark.parametrize("name", sorted(ZOO_BLOCK_OPS))
def test_exported_int8_zoo_runs_the_block_forms(zoo, tmp_path, name):
    """``runtime/export.py`` exports the int8 difv4 / difvdsr with X4's block
    forms as opaque ``iek::`` nodes (their fake registrations), and the loaded
    program gives ``upscale``'s bytes."""
    from image_enhance_keras_tpu_torch.runtime import export

    img = np.random.default_rng(15).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    _, pr = _engines(zoo, name, mode="fast")
    x = img
    if pr.spec.pre_upscaled_input:  # the artifact takes the bicubic-upscaled serving input
        x = pr._pre_upscale(torch.from_numpy(img)).to(torch.uint8).numpy()
    path = str(tmp_path / "zoo.iekx")
    export.export_pipeline(pr, x.shape[:2], path)
    fn = export.load_forward(path)
    np.testing.assert_array_equal(fn(x), pr.upscale(img))
    ops = {n.target.name().split("::")[1].split(".")[0] for n in fn.program.graph.nodes
           if n.op == "call_function" and getattr(n.target, "namespace", None) == "iek"}
    assert ZOO_BLOCK_OPS[name] <= ops and "int8_conv3" not in ops


@pytest.mark.parametrize("mode", ["fast", "split2d"])
def test_engine_subpixel_dynamic_tail_byte_equal_eager_jax(zoo, mode):
    img = np.random.default_rng(14).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    jr, pr = _engines(zoo, "didbl_subpixel", dict(int8_dynamic_tail=True), **MODES[mode])
    with jax.disable_jit():
        want = np.asarray(jr.upscale(img))
    np.testing.assert_array_equal(pr.upscale(img), want)


@pytest.mark.parametrize("name", ["difv4", "difvdsr"])
def test_engine_refuses_what_jax_refuses(zoo, name):
    """int8_dynamic_tail outside the didbl family; split on int8 difvdsr's body/tail."""
    img = np.zeros((8, 8, 3), np.uint8)
    jr, pr = _engines(zoo, name, dict(int8_dynamic_tail=True), mode="fast")
    for r in (jr, pr):
        with pytest.raises(ValueError, match="didbl family|not available"):
            r.upscale(img)


# -- the CLI --------------------------------------------------------------------

#: the quantizer each CLI calls, by model: (JAX module, port module, function name)
_QUANTIZERS = {"didbl_subpixel": (jax_dp, dp, "quantize_didbl_params"),
               "difv4": (jax_zi, zi, "quantize_difv4_params"),
               "difvdsr": (jax_zi, zi, "quantize_difvdsr_params")}


@pytest.fixture()
def cli_setup(zoo, tmp_path, monkeypatch):
    """Both registries patched to the narrow models, weights in npz files, and
    both packages' quantization replaced by JAX's (op by op) on each
    package's own calibration input, so that the CLIs run the same codes."""
    def getter(side):
        def get(name, dtype=None, **kw):
            cfg, fcls, pcls, scale, pre = ZOO[name]
            cls, spec = (fcls, jax_zoo.ModelSpec) if side == "jax" else (pcls, port_zoo.ModelSpec)
            return cls(**cfg, **({"dtype": dtype} if side == "jax" else {})), spec(name, None, scale, pre, "n", None)
        return get

    monkeypatch.setattr(jax_engine, "get_model", getter("jax"))
    monkeypatch.setattr(port_engine, "get_model", getter("port"))
    seen = []
    for jmod, pmod, fn in _QUANTIZERS.values():
        jfn = getattr(jmod, fn)

        def eager(*a, _f=jfn, **kw):
            with jax.disable_jit():
                return _f(*a, **kw)

        def port(params, *a, _f=jfn, **kw):
            a = [jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for v in a]
            kw = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            seen.append([v for v in [*a, *kw.values()] if isinstance(v, jax.Array)][0].shape)
            with jax.disable_jit():
                jq = _f(jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params), *a, **kw)
            return params_from_numpy(jax.tree_util.tree_map(np.asarray, jq))

        monkeypatch.setattr(jmod, fn, eager)
        monkeypatch.setattr(pmod, fn, port)
    npz = {}
    for name, (pn, *_rest) in zoo.items():
        npz[name] = str(tmp_path / f"{name}.npz")
        np.savez(npz[name], **flatten_params(pn))
    calib = tmp_path / "calib"
    calib.mkdir()
    _bmp_write(str(calib / "c.bmp"), np.random.default_rng(15).integers(0, 256, (72, 88, 3), dtype=np.uint8))
    img = np.random.default_rng(16).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path / side
        dirs[side].mkdir()
        _bmp_write(str(dirs[side] / "img.bmp"), img)
    return dirs, npz, str(calib), seen


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("name", ["didbl_subpixel", "difv4", "difvdsr"])
def test_main_dirpath_int8_byte_equal_eager_jax_cli(cli_setup, monkeypatch, name, acc):
    """``--forward int8 --dtype bfloat16`` through both CLIs (the JAX one op by
    op), each calibrating on ``--int8-calib-dir`` (one 72x88 image)."""
    dirs, npz, calib, seen = cli_setup
    monkeypatch.delenv("IEK_INT8_ACC", raising=False)
    common = ["--model", name, "--weights", npz[name], "--forward", "int8", "--int8-acc", acc, "--dtype", "bfloat16",
              "--int8-calib-dir", calib, "--mode", "fast"]
    with jax.disable_jit():
        assert jax_main([str(dirs["jax"]), *common]) == 0
    assert port_main([str(dirs["port"]), *common, "--device", "cpu"]) == 0
    assert "IEK_INT8_ACC" not in os.environ
    # the calibration crop: 72x88 / 4 -> an 18 square, re-upscaled x4 for difvdsr
    assert seen == [(1, 72, 72, 3) if name == "difvdsr" else (1, 18, 18, 3)]
    got = imread(str(dirs["port"] / "img_scaled(1x).bmp"))
    want = imread(str(dirs["jax"] / "img_scaled(1x).bmp"))
    assert got.shape == (80, 112, 3)
    np.testing.assert_array_equal(got, want)
