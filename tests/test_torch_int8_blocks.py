"""Port's int8 Light53 / Light blocks against the JAX Pallas int8 kernels.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there, expecting bit-equality); here the wrappers take
their plain versions because the tensors lie on the CPU.  The JAX kernels
run in interpret mode with static activation scales on bf16 input, C = 16,
over several TPU windows (``tile``).  Both compute exact s32 convolutions
and the same float steps, the dequant and the epilogue's multiply-add fused
as XLA fuses them; XLA may still contract or order a step otherwise, which
can flip one int8 code.  Bound: at most 0.1% of the outputs differ, none by
more than 1% of max|ref| (measured: no value differs but two of 30,720 in
one case, by 7.8e-6 of max|ref|).  The dynamic-scale and float32 forms are
in tests/test_torch_int8_dynamic.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhance_keras_tpu.ops.pallas import int8_blocks as jax_i8
from image_enhance_keras_tpu_torch.ops.cuda import int8_blocks as i8

C = 16
MAX_FRAC, MAX_REL = 1e-3, 1e-2


def _case(hw, seed):
    """bf16 input, quantized weights of a Light53 block, static scales."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray((rng.standard_normal((2, *hw, C)) * 0.5).astype(np.float32)).astype(jnp.bfloat16)
    convs = []
    for k in (3, 5, 5, 3):
        w = (rng.standard_normal((k, k, C, C)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(C) * 0.01).astype(np.float32)
        q, s = jax_i8.quantize_weights_per_channel(w)
        convs.append((np.asarray(q), np.asarray(s), b))
    act = np.array([float(jnp.max(jnp.abs(x.astype(jnp.float32)))) / 127, 0.02, 0.03], np.float32)
    return x, convs, act


def _port(x, convs, act):
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    args = [torch.from_numpy(np.array(a)) for conv in convs for a in conv]
    return xt, args, torch.from_numpy(act)


def _assert_close(got, want):
    d = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    frac, rel = float((d > 0).mean()), float(d.max() / np.abs(np.asarray(want, np.float32)).max())
    print(f"differing fraction {frac:.3g}, max |diff| / max|ref| {rel:.3g}")
    assert frac <= MAX_FRAC and rel <= MAX_REL, (frac, rel)


@pytest.mark.parametrize("k", [3, 5])
def test_quantize_weights_per_channel_equals_jax(k):
    w = (np.random.default_rng(k).standard_normal((k, k, C, 24)) * 0.05).astype(np.float32)
    q, s = jax_i8.quantize_weights_per_channel(w)
    got_q, got_s = i8.quantize_weights_per_channel(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s))


@pytest.mark.parametrize("hw,tile", [((13, 21), (8, 8)), ((16, 16), (64, 128)), ((40, 24), (8, 16))])
def test_light53_int8_matches_jax_interpret(hw, tile):
    x, convs, act = _case(hw, 1)
    want = jax_i8.light53_int8(x, *[jnp.asarray(a) for c in convs for a in c], tile=tile,
                               interpret=True, act_scales=jnp.asarray(act))
    xt, args, at = _port(x, convs, act)
    got = i8.light53_int8(xt, *args, tile=tile, act_scales=at)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    _assert_close(got, want)


@pytest.mark.parametrize("hw,tile", [((13, 21), (8, 8)), ((16, 16), (64, 128))])
def test_light_int8_matches_jax_interpret(hw, tile):
    x, convs, act = _case(hw, 2)
    convs = [convs[0], convs[3]]
    want = jax_i8.light_int8(x, *[jnp.asarray(a) for c in convs for a in c], tile=tile,
                             interpret=True, act_scales=jnp.asarray(act[:2]))
    xt, args, at = _port(x, convs, act[:2])
    got = i8.light_int8(xt, *args, tile=tile, act_scales=at)
    _assert_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_other_activation_dtypes_raise(dtype):
    """The blocks take bf16 or float32 activations (as the TPU kernels do), nothing else."""
    x, convs, act = _case((9, 10), 3)
    xt, args, at = _port(x, convs, act)
    with pytest.raises(TypeError, match="bfloat16"):
        i8.light53_int8(xt.to(dtype), *args, act_scales=at)
    with pytest.raises(TypeError, match="bfloat16"):
        i8.light_int8(xt.to(dtype), *args[:3], *args[9:], act_scales=at[:2])


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    x, convs, act = _case((8, 12), 5)
    xt, args, at = _port(x, convs, act)
    before = (i8.light53_int8.launches, i8.light_int8.launches)
    assert torch.equal(i8.light53_int8(xt, *args, act_scales=at), i8.light53_int8_plain(xt, *args, at))
    light_args = args[:3] + args[9:]
    assert torch.equal(i8.light_int8(xt, *light_args, act_scales=at[:2]),
                       i8.light_int8_plain(xt, *light_args, at[:2]))
    assert (i8.light53_int8.launches, i8.light_int8.launches) == before


def test_wrapper_rejects_bad_args():
    x, convs, act = _case((8, 8), 6)
    xt, args, at = _port(x, convs, act)
    with pytest.raises(ValueError, match="int8"):
        i8.light53_int8(xt, args[0].float(), *args[1:], act_scales=at)
    with pytest.raises(ValueError, match="act_scales"):
        i8.light53_int8(xt, *args, act_scales=at[:2])
    with pytest.raises(ValueError, match="cpu or cuda"):
        i8.light53_int8(xt.to("meta"), *(a.to("meta") for a in args), act_scales=at.to("meta"))


def test_packed_weight_layout():
    """[tap][cin/32][K half][cout][16]: 16 input channels of one output channel per row."""
    wq = torch.from_numpy(np.random.default_rng(7).integers(-127, 128, (3, 3, 64, 8), dtype=np.int8))
    p = i8._packed(wq)
    assert tuple(p.shape) == (9, 2, 2, 8, 16) and p.is_contiguous()
    for ky, kx, ch, hf, co, j in [(0, 0, 0, 0, 0, 0), (2, 1, 1, 1, 7, 15), (1, 2, 0, 1, 4, 3)]:
        assert p[3 * ky + kx, ch, hf, co, j] == wq[ky, kx, 32 * ch + 16 * hf + j, co]
    assert i8._packed(wq) is p  # cached with the tensor
    wq.add_(1)
    assert i8._packed(wq) is not p  # an in-place change repacks
