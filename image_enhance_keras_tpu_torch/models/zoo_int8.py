"""Engine dispatch of the XLA-int8 forward (mirror of ``models/zoo_int8.py``).

This slice ports the didbl branch (``DifvdsrDouble`` with the
``tf1_bilinear`` head, the only head the port's model builds); the
subpixel head, difv4 and difvdsr are not yet ported.
"""

from __future__ import annotations

from image_enhance_keras_tpu_torch.models import didbl_pallas as dp

__all__ = ["int8_support"]


def int8_support(module):
    """``(quantize_fn, apply_fn, body_fn, tail_fn)`` of ``forward='int8'``,
    bound to the module's config, or None when the model has no int8 path."""
    if type(module).__name__ != "DifvdsrDouble" or module.upsampler != "tf1_bilinear":
        return None
    kw = dict(n_body53=module.n_body53, n_light=module.n_light, n_tail53=module.n_tail53)
    return (
        lambda params, calib: dp.quantize_didbl_params(params, calib_x=calib, scale=module.scale, **kw),
        lambda qp, x: dp.apply_didbl_int8_xla(qp, x, scale=module.scale, **kw),
        lambda qp, x: dp.apply_didbl_int8_xla_body(qp, x, n_body53=module.n_body53,
                                                   n_light=module.n_light),
        lambda qp, h: dp.apply_didbl_int8_xla_tail(qp, h, n_tail53=module.n_tail53,
                                                   scale=module.scale),
    )
