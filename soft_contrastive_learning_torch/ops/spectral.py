"""Spectral primitives of the eigenvalue and SVD losses, own copy of
``soft_contrastive_learning_tpu/ops/spectral.py``.

Only singular values are needed and M << D (tuples of ~12-25 embeddings of
dimension up to 32,768), so they come from the eigenvalues of the small-side
Gram matrix, ``s_i(X) = sqrt(eigvals(X X^T))``: one product and an M x M
``torch.linalg.eigvalsh``. The same safeguards as JAX's, in the same order:
the Gram is symmetrized and gets a relative diagonal jitter
``1e-10 * (mean|diag| + 1)``, which keeps the eigensolve's gradient finite at
degenerate spectra; singular values are ``sqrt(max(eig, 1e-30))``; a product
of singular values is taken in log space.

The Gram is an fp32 product at full precision, as JAX's
``precision="highest"``: its forward runs with TF32 off whatever the caller
set (``pca/whiten.py::fp32_matmuls``), since the jitter and a product of 10
singular values mean nothing at TF32's 10-bit mantissa; its backward runs
under the process's setting, off by PyTorch's default.

The eigensolve of that fp32 Gram runs in float64 (``_eigvalsh``), on the
device where the Gram is. On an H100, cuSOLVER's fp32 solver for these
small batches (a batched Jacobi) fails to converge on some wrd-like Grams,
whose weighted residuals hold many near-zero rows, and errs by up to the
largest eigenvalue on others, where float64 converges on all
(``chip_smoke.py``'s ``losses`` phase counts both). ``torch.linalg`` checks
the solver's status on the host, so each call waits for the device.
"""

from __future__ import annotations

import torch

from soft_contrastive_learning_torch.pca.whiten import fp32_matmuls

_JITTER = 1e-10
_TINY = 1e-30


def _jittered_gram(features: torch.Tensor, rows: bool = True) -> torch.Tensor:
    """(T, M, D) -> X X^T (T, M, M), or X^T X (T, D, D) when not ``rows``;
    symmetrized, with the relative diagonal jitter."""
    xt = features.transpose(1, 2)
    with fp32_matmuls():
        gram = features @ xt if rows else xt @ features
    gram = 0.5 * (gram + gram.transpose(1, 2))
    scale = torch.diagonal(gram, dim1=1, dim2=2).abs().mean(dim=-1)
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    return gram + (_JITTER * (scale[:, None, None] + 1.0)) * eye


def _eigvalsh(gram: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of a batch of symmetric matrices, solved in
    float64, in the matrices' dtype."""
    return torch.linalg.eigvalsh(gram.double()).to(gram.dtype)


def gram_eigvals(features: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of X X^T for batched (T, M, D) features -> (T, M)."""
    return _eigvalsh(_jittered_gram(features))


def min_eigenvalues(features: torch.Tensor) -> torch.Tensor:
    """(T, M, D) -> (T,) smallest Gram eigenvalue."""
    return gram_eigvals(features)[:, 0]


def max_eigenvalues(features: torch.Tensor) -> torch.Tensor:
    """(T, M, D) -> (T,) largest Gram eigenvalue."""
    return gram_eigvals(features)[:, -1]


def gram_trace(features: torch.Tensor) -> torch.Tensor:
    """(T, M, D) -> (T,) trace of X X^T, the sum of squares."""
    return (features * features).sum(dim=(1, 2))


def svdvals_descending(features: torch.Tensor) -> torch.Tensor:
    """Singular values of batched (T, M, D), descending, (T, min(M, D)),
    from the eigenvalues of the smaller Gram."""
    _, m, d = features.shape
    eig = _eigvalsh(_jittered_gram(features, rows=m <= d))  # ascending
    s = torch.sqrt(torch.clamp(eig, min=_TINY))
    return s.flip(-1)


def top_svdvals(features: torch.Tensor, dimensions: int) -> torch.Tensor:
    """Top-``dimensions`` singular values, descending, (T, dimensions)."""
    s = svdvals_descending(features)
    return s[:, : min(dimensions, s.shape[-1])]


def stable_prod(values: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """prod(values) for nonnegative values, in log space (no fp32 under- or
    overflow when many values are multiplied)."""
    return torch.exp(torch.log(torch.clamp(values, min=_TINY)).sum(dim=dim))
