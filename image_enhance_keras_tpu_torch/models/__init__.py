"""The model zoo (didbl, difv4, difvdsr, didbl_subpixel), its blocks, the kernel forwards and the registry."""

from image_enhance_keras_tpu_torch.models.blocks import (  # noqa: F401
    LightBlock,
    Light53Block,
    DiffBlock,
)
from image_enhance_keras_tpu_torch.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    ModelSpec,
    get_model,
    init_params,
)
from image_enhance_keras_tpu_torch.models.didbl import DifvdsrDouble  # noqa: F401
from image_enhance_keras_tpu_torch.models.difv4 import Difvdsr4  # noqa: F401
from image_enhance_keras_tpu_torch.models.difvdsr import Difvdsr  # noqa: F401
