"""Winograd / Toom-Cook convolution for the residual-block convs (mirror of ``ops/winograd.py``).

F(m x m, k x k) computes an m x m output tile with (m+k-1)^2 elementwise
products where a direct conv does (m*k)^2 multiply-adds: F(2,3) 16 vs 36,
F(2,5) 36 vs 100, F(4,3) 36 vs 144.  With channels the elementwise products
become (m+k-1)^2 (P, Cin) x (Cin, Cout) matrix products.

The transforms come from the transposition principle on Toom-Cook full
convolution with n = m + k - 1 points (n - 1 finite, 0, 1, -1, 2, -2, ...,
and infinity): A^T = V_m^T, G = V_k, B^T = V_n^{-T}, V_j the n x j
Vandermonde matrix of the points.  The transforms run in float32; the
products take their operands in the compute dtype and sum in float32.

Like the JAX version this is an experiment op: no forward uses it.  JAX
computes the products as XLA dots outside any Pallas kernel, and so this
port computes them with ``torch.matmul``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["winograd_matrices", "winograd_conv2d_same", "flops_ratio"]


@functools.lru_cache(maxsize=None)
def _matrices_np(m: int, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A^T (m,n), G (n,k), B^T (n,n)) float64 for F(m, k), n = m+k-1."""
    n = m + k - 1
    pts = [0]
    v = 1
    while len(pts) < n - 1:
        pts.append(v)
        if len(pts) < n - 1:
            pts.append(-v)
        v += 1

    def vand(cols: int) -> np.ndarray:
        """n x cols: rows [p^0 ... p^(cols-1)]; the infinity row selects the leading coefficient."""
        V = np.zeros((n, cols), dtype=np.float64)
        for i, p in enumerate(pts):
            V[i] = [float(p) ** j for j in range(cols)]
        V[n - 1, cols - 1] = 1.0
        return V

    return vand(m).T, vand(k), np.linalg.inv(vand(n)).T


def winograd_matrices(m: int, k: int, device: str | torch.device = "cpu"):
    """float32 copies of (A^T, G, B^T) for F(m x m, k x k) on ``device``."""
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in _matrices_np(m, k))


def flops_ratio(m: int, k: int) -> float:
    """Direct multiply-adds / Winograd products per m x m output tile."""
    n = m + k - 1
    return (m * k) ** 2 / float(n * n)


def winograd_conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, m: int = 2,
                         dtype: torch.dtype | None = None) -> torch.Tensor:
    """SAME k x k conv of x (N, H, W, Cin) with HWIO w via Winograd F(m x m, k x k).

    The transforms run in float32; the (m+k-1)^2 products take their
    operands rounded to ``dtype`` (default x's dtype) and sum in float32,
    as JAX's dot with ``preferred_element_type=float32``.  Not bit-equal to
    a direct conv: agreement is numerical (about 1e-6 relative in float32)."""
    n_, h, w_, cin = (int(s) for s in x.shape)
    k, cout = int(w.shape[0]), int(w.shape[-1])
    n = m + k - 1
    r = k // 2
    dot_dtype = dtype or x.dtype
    f32 = torch.float32
    A_t, G, B_t = winograd_matrices(m, k, x.device)
    # U = G g G^T per channel pair: (n, n, Cin, Cout)
    u = torch.einsum("ia,abcd->ibcd", G, w.to(f32))
    u = torch.einsum("jb,ibcd->ijcd", G, u).to(dot_dtype)
    # SAME halo, H and W rounded up to multiples of m
    hp, wp = -(-h // m) * m, -(-w_ // m) * m
    xp = F.pad(x.to(f32), (0, 0, r, wp - w_ + (n - m - r), r, hp - h + (n - m - r)))
    th, tw = hp // m, wp // m
    # the n x n input tiles at stride m: d[a, b] (N, th, tw, C)
    d = torch.stack([torch.stack([xp[:, a : a + (th - 1) * m + 1 : m, bc : bc + (tw - 1) * m + 1 : m]
                                  for bc in range(n)]) for a in range(n)])
    v = torch.einsum("ia,ab...->ib...", B_t, d)
    v = torch.einsum("jb,ib...->ij...", B_t, v)
    v2 = v.to(dot_dtype).to(f32).reshape(n * n, n_ * th * tw, cin)
    mprod = torch.matmul(v2, u.to(f32).reshape(n * n, cin, cout)).reshape(n, n, n_, th, tw, cout)
    y = torch.einsum("ia,ab...->ib...", A_t, mprod)
    y = torch.einsum("jb,ib...->ij...", A_t, y)
    # the m x m phases back to (N, H, W, Cout)
    y = y.permute(2, 3, 0, 4, 1, 5).reshape(n_, hp, wp, cout)[:, :h, :w_, :]
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)
