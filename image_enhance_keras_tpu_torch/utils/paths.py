"""Repo-relative asset resolution (mirror of ``utils/paths.py``).

Try the CWD first (a repo-root invocation, or a caller's own copy of the
asset), then the checkout that holds this package.
"""

from __future__ import annotations

import os

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the checkout containing the image_enhance_keras_tpu_torch package
REPO_ROOT = os.path.dirname(_PKG_ROOT)


def find_repo_asset(rel: str | None) -> str | None:
    """Existing path for a repo-relative asset, or None."""
    if not rel:
        return None
    if os.path.exists(rel):
        return rel
    if os.path.isabs(rel):
        return None
    cand = os.path.join(REPO_ROOT, rel)
    return cand if os.path.exists(cand) else None
