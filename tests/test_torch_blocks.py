"""Port's Light53 / Light blocks against the JAX Pallas kernels and flax modules.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there); here the wrappers take their plain versions
because the tensors lie on the CPU.  Tolerance 2e-5 as in
tests/test_pallas_blocks.py: float32 sums over 68*128 terms in another order.
"""

import os
import re
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.models.blocks import Light53Block as FlaxLight53, LightBlock as FlaxLight
from image_enhance_keras_tpu.ops.pallas.blocks import fused_light53_block as pallas_light53
from image_enhance_keras_tpu.ops.pallas.blocks import fused_light_block as pallas_light
from image_enhance_keras_tpu_torch.models.blocks import Light53Block, LightBlock
from image_enhance_keras_tpu_torch.models.weights import load_params, params_from_numpy
from image_enhance_keras_tpu_torch.ops.cuda import _build
from image_enhance_keras_tpu_torch.ops.cuda import blocks as kb

C = 128
SHAPE = (2, 10, 14, C)
ATOL = 2e-5
L53_CONVS = ("conv_a1", "conv_a2", "conv_b1", "conv_b2")
L_CONVS = ("conv_a", "conv_b")


def _setup(flax_cls, seed):
    x = np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)
    mod = flax_cls(C)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    return x, jax.tree_util.tree_map(np.asarray, params), want


def _args(tree, convs):
    return [tree[c][k] for c in convs for k in ("kernel", "bias")]


def test_light53_plain_matches_pallas_and_flax():
    x, pn, want = _setup(FlaxLight53, 1)
    pallas = np.asarray(pallas_light53(jnp.asarray(x), *_args(pn, L53_CONVS), res_scale=0.1,
                                       identity_scale=0.9, interpret=True))
    got = kb.light53_block_plain(torch.from_numpy(x), *_args(params_from_numpy(pn), L53_CONVS)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_light_plain_matches_pallas_and_flax():
    x, pn, want = _setup(FlaxLight, 2)
    pallas = np.asarray(pallas_light(jnp.asarray(x), *_args(pn, L_CONVS), res_scale=0.1, interpret=True))
    got = kb.light_block_plain(torch.from_numpy(x), *_args(params_from_numpy(pn), L_CONVS)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, pallas, atol=ATOL)


@pytest.mark.parametrize("flax_cls,port_cls,seed", [(FlaxLight53, Light53Block, 3), (FlaxLight, LightBlock, 4)])
def test_port_modules_match_flax(flax_cls, port_cls, seed):
    x, pn, want = _setup(flax_cls, seed)
    mod = port_cls(C)
    load_params(mod, pn)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("which", ["light53", "light"])
def test_cpu_wrapper_takes_plain_version(which):
    x, pn, _ = _setup(FlaxLight53 if which == "light53" else FlaxLight, 5)
    tp = params_from_numpy(pn)
    if which == "light53":
        wrapper, plain, args = kb.fused_light53_block, kb.light53_block_plain, _args(tp, L53_CONVS)
    else:
        wrapper, plain, args = kb.fused_light_block, kb.light_block_plain, _args(tp, L_CONVS)
    before = wrapper.launches
    xt = torch.from_numpy(x)
    assert torch.equal(wrapper(xt, *args), plain(xt, *args))
    assert wrapper.launches == before  # the count is of kernel launches only


@pytest.mark.parametrize("which", ["light53", "light"])
def test_cpu_wrappers_take_any_channel_count(which):
    """The C = 128 limit is the CUDA kernels' (their wgmma tile's N): on CPU
    tensors the wrappers run the plain versions at any width."""
    c = 16
    rng = np.random.default_rng(11)
    wrapper, plain, sizes = {
        "light53": (kb.fused_light53_block, kb.light53_block_plain, (3, 5, 5, 3)),
        "light": (kb.fused_light_block, kb.light_block_plain, (3, 3)),
    }[which]
    x = torch.from_numpy(rng.normal(size=(1, 6, 9, c)).astype(np.float32))
    args = []
    for ks in sizes:
        args += [torch.from_numpy((rng.normal(size=(ks, ks, c, c)) * 0.1).astype(np.float32)),
                 torch.from_numpy((rng.normal(size=c) * 0.05).astype(np.float32))]
    assert torch.equal(wrapper(x, *args), plain(x, *args))


def test_wrapper_rejects_other_devices_and_bad_args():
    _, pn, _ = _setup(FlaxLight, 6)
    args = _args(params_from_numpy(pn), L_CONVS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kb.fused_light_block(torch.empty(SHAPE, device="meta"), *(a.to("meta") for a in args))
    with pytest.raises(TypeError, match="float32"):
        kb.fused_light_block(torch.zeros(SHAPE, dtype=torch.float64), *args)
    with pytest.raises(ValueError, match="kernel shape"):
        kb.fused_light_block(torch.zeros(SHAPE), args[2][:1], *args[1:])


def test_failed_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    """No fallback: a failing nvcc surfaces its own output as the error."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fake nvcc: error: no device compiler here' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="no device compiler here"):
        _build.library("blocks")
    assert not os.listdir(tmp_path / "build")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def _c_kind(param: str):
    """The ctypes type a C parameter takes: a pointer (or stream), a float or an int."""
    if "*" in param or "cudaStream_t" in param:
        return _build.ctypes.c_void_p
    return _build.ctypes.c_float if param.split()[-2] == "float" else _build.ctypes.c_int


@pytest.mark.parametrize("stem,entry", [(s, e) for s, sigs in _build.SIGNATURES.items() for e in sigs])
def test_entry_signature_matches_its_c_prototype(stem, entry):
    """Each ctypes signature has the C entry's parameters, kind for kind: a
    wrong count or kind shows on the CPU, not at the first launch on the card."""
    src = open(os.path.join(_build.CSRC, f"{stem}.cu")).read()
    m = re.search(rf"\bint {entry}\(([^)]*)\)\s*\{{", src)
    assert m, f"csrc/{stem}.cu defines no int {entry}(...)"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    assert [_c_kind(p) for p in params] == _build.SIGNATURES[stem][entry]
