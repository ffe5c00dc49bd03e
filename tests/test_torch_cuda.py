"""The port's CUDA kernels on the card (marked ``cuda``; each skips without one).

Imports no JAX, so it runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

from image_enhance_keras_tpu_torch.ops.cuda import tower

C = 128
#: K float32 blocks summed in another order (tests/test_pallas_tower.py)
ATOL = 5e-5
CHAINS = {
    "light53": (tower.fused_light53_chain, tower.light53_chain_plain, (3, 5, 5, 3), 3, (2, 8, 8, C)),
    "light": (tower.fused_light_chain, tower.light_chain_plain, (3, 3), 4, (1, 10, 6, C)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(CHAINS))
def test_chain_kernels_match_plain(which, monkeypatch):
    """One launch per chain, equal to the plain version within 5e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the chain kernels are CUDA C++ with no CPU mode")
    wrapper, plain, sizes, k, shape = CHAINS[which]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
    args = []
    for ks in sizes:
        args.append(torch.from_numpy((rng.normal(size=(k, ks, ks, C, C)) * (2.0 / (ks * ks * C)) ** 0.5)
                                     .astype(np.float32)).cuda())
        args.append(torch.from_numpy((rng.normal(size=(k, C)) * 0.05).astype(np.float32)).cuda())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full float32 plain convs
    before = wrapper.launches
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain(x, *args).cpu().numpy(), atol=ATOL)
