"""Hand-written CUDA kernels (``csrc/*.cu``), built with nvcc and bound with ctypes."""


def counted_wrappers() -> tuple:
    """Every kernel wrapper that counts its launches in ``.launches``."""
    from image_enhance_keras_tpu_torch.ops.cuda import blocks, int8_blocks, int8_conv, int8_xla, tower, upsample

    return (
        blocks.fused_light53_block, blocks.fused_light_block,
        int8_blocks.light53_int8, int8_blocks.light_int8,
        int8_conv.int8_conv3, int8_conv.int8_conv3_dyn, int8_conv.int8_conv3_codes, int8_conv.int8_conv3_light,
        int8_conv.int8_conv3_diff_b, int8_conv.int8_conv3_diff_d,
        int8_xla.light53_int8_xla, int8_xla.light53_int8_xla_upq, int8_xla.light_int8_xla,
        int8_xla.light53_int8_xla_dyn,
        tower.fused_light53_chain, tower.fused_light_chain,
        upsample.upsample_phase_tf1_kernel, upsample.upsample_quant_tf1,
    )


def hand_launches() -> int:
    """The launches counted so far by every counting wrapper."""
    return sum(f.launches for f in counted_wrappers())
