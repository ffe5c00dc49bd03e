"""Shared CLI policies (mirror of ``cli/common.py``): the --weights contract."""

from __future__ import annotations

from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def resolve_cli_weights(model: str, weights: str | None) -> str | None:
    """Explicit path verbatim; ``"none"`` = random init (loud); omitted = the
    committed demo checkpoint, or SystemExit when the family has none."""
    if weights == "none":
        log.warning("--weights none: serving RANDOM-INIT weights")
        return None
    if weights is not None:
        return weights
    from image_enhance_keras_tpu_torch.models.zoo import MODEL_REGISTRY, resolve_default_weights

    spec = MODEL_REGISTRY[model]
    default = resolve_default_weights(spec)
    if default:
        log.info("no --weights given; using the demo checkpoint %r", default)
        return default
    raise SystemExit(
        f"no --weights given and no committed demo checkpoint exists for {model!r} "
        f"(default_weights={spec.default_weights!r}); pass --weights, or use "
        f"'--weights none' for an explicit random-init run"
    )
