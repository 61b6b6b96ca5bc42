"""Centered Kernel Alignment (CKA) representation-similarity metrics
(counterpart of mafed_tpu/analysis/cka.py).

The reference's vendored google-research CKA (mafed/analysis/cka.py:10-195):
linear and RBF gram matrices, biased and debiased HSIC estimators, and the
feature-space linear form, on torch tensors on their own device, in float32
(float64 where the input is float64). On the card the products are plain
torch.matmul calls, as the JAX package leaves them to XLA, and they must run
in full float32: TF32 keeps ~3 decimal digits, so a call with TF32 matmuls
switched on raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x, dtype=None) -> torch.Tensor:
    """x as a tensor (numpy arrays are copied over), in `dtype` if given;
    on the card, refused while TF32 matmuls are on."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("CKA needs full float32 matmuls: torch.backends.cuda.matmul.allow_tf32 is on")
    return t if dtype is None else t.to(dtype)


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def gram_linear(x) -> torch.Tensor:
    """Gram matrix for a linear kernel. x: [n, features]."""
    x = _tensor(x)
    return x @ x.T


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median of all elements, the mean of the two middle ones for an
    even count (numpy's and jnp.median's; torch.median takes the lower one)."""
    v = x.flatten().sort().values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) / 2


def gram_rbf(x, threshold: float = 1.0) -> torch.Tensor:
    """RBF-kernel gram with bandwidth = threshold * median distance."""
    x = _tensor(x)
    dot = x @ x.T
    sq_norms = torch.diagonal(dot)
    sq_dist = sq_norms[:, None] + sq_norms[None, :] - 2 * dot
    return torch.exp(-sq_dist / (2 * threshold ** 2 * _median(sq_dist) + 1e-12))


def center_gram(gram, unbiased: bool = False) -> torch.Tensor:
    """Center a symmetric gram matrix (optionally the unbiased estimator)."""
    gram = _tensor(gram)
    n = gram.shape[0]
    if unbiased:
        gram = gram - torch.diag(torch.diagonal(gram))
        means = torch.sum(gram, dim=0) / (n - 2)
        means = means - torch.sum(means) / (2 * (n - 1))
        gram = gram - means[:, None] - means[None, :]
        return gram - torch.diag(torch.diagonal(gram))
    means = torch.mean(gram, dim=0)
    means = means - torch.mean(means) / 2
    return gram - means[:, None] - means[None, :]


def cka_from_gram(gram_x, gram_y, debiased: bool = False) -> float:
    """CKA between two gram matrices."""
    gx = center_gram(gram_x, unbiased=debiased)
    gy = center_gram(gram_y, unbiased=debiased)
    hsic = torch.sum(gx * gy)
    norm_x = torch.sqrt(torch.sum(gx * gx))
    norm_y = torch.sqrt(torch.sum(gy * gy))
    return float(hsic / (norm_x * norm_y + 1e-12))


def feature_space_linear_cka(x, y, debiased: bool = False) -> float:
    """Linear CKA computed in feature space: O(n d^2) instead of O(n^2 d)."""
    x, y = _tensor(x), _tensor(y)
    x, y = x.to(_compute_dtype(x)), y.to(_compute_dtype(y))
    x = x - torch.mean(x, dim=0, keepdim=True)
    y = y - torch.mean(y, dim=0, keepdim=True)

    dot_similarity = torch.linalg.norm(x.T @ y) ** 2
    norm_x = torch.linalg.norm(x.T @ x)
    norm_y = torch.linalg.norm(y.T @ y)

    if debiased:
        n = x.shape[0]
        sq_x = torch.square(torch.linalg.norm(x, dim=1))
        sq_y = torch.square(torch.linalg.norm(y, dim=1))
        dot_similarity = _debias_dot(dot_similarity, sq_x, sq_y, n)
        norm_x = torch.sqrt(torch.clamp(_debias_dot(norm_x ** 2, sq_x, sq_x, n), min=0.0))
        norm_y = torch.sqrt(torch.clamp(_debias_dot(norm_y ** 2, sq_y, sq_y, n), min=0.0))

    return float(dot_similarity / (norm_x * norm_y + 1e-12))


def _debias_dot(xty_sq, sq_row_x, sq_row_y, n: int):
    """Song et al. unbiased HSIC correction in feature space."""
    sum_x = torch.sum(sq_row_x)
    sum_y = torch.sum(sq_row_y)
    return xty_sq - n / (n - 2) * torch.sum(sq_row_x * sq_row_y) + sum_x * sum_y / ((n - 1) * (n - 2))
