from image_enhance_keras_tpu_torch.eval.evaluate import (  # noqa: F401
    BicubicResolver,
    degrade,
    evaluate_model,
    evaluate_resolver_on_dir,
    evaluate_resolver_on_dir_divisible,
)
from image_enhance_keras_tpu_torch.eval.scorer import (  # noqa: F401
    PairScore,
    find_pairs,
    score_directory,
    score_pair,
)
