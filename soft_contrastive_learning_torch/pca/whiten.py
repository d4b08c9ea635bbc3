"""Full-batch whitening PCA for the top-N evaluation protocol, the
counterpart of ``soft_contrastive_learning_tpu/pca/whiten.py``
(``fit_pca``, ``PCAWhitener``, ``whiten_features``):
``sklearn.decomposition.PCA(whiten=True)`` semantics on the device.

For N samples of dimension D the decomposition runs on the smaller side:
the (N, N) Gram matrix when N <= D (the usual case for 32,768-D NetVLAD
descriptors), else the (D, D) covariance. Its products run in fp32 with
TF32 off, pinned inside these functions (``fp32_matmuls``), whatever the
caller set. The symmetric eigendecomposition runs on the host in float64
numpy (LAPACK) at sides of 1024 and up, as in the JAX package, and with
``torch.linalg.eigh`` where the matrix lies below that; ``host_eigh``
forces either. Eigenvector signs (and the basis inside a degenerate
eigenspace) differ between LAPACK, cuSOLVER and XLA: compare fits by
sign-invariant quantities.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from soft_contrastive_learning_torch.core.config import resolve_device

# At/above this matrix side, eigh runs on the host in float64
_HOST_EIGH_THRESHOLD = 1024


_tf32 = {"lock": threading.Lock(), "depth": 0, "saved": False}


@contextlib.contextmanager
def fp32_matmuls():
    """CUDA fp32 matrix products in full fp32 (TF32 off) inside the block;
    the caller's setting is restored after. The flag is the process's, not
    the thread's: where it is off already (PyTorch's default) nothing is
    written; else the first block to enter, on any thread, clears it and the
    last to leave sets it again, so that blocks that overlap on two threads
    (a training step's spectral loss and a worker's) never restore a value
    that another one set."""
    with _tf32["lock"]:
        if _tf32["depth"] == 0:
            _tf32["saved"] = torch.backends.cuda.matmul.allow_tf32
            if _tf32["saved"]:
                torch.backends.cuda.matmul.allow_tf32 = False
        _tf32["depth"] += 1
    try:
        yield
    finally:
        with _tf32["lock"]:
            _tf32["depth"] -= 1
            if _tf32["depth"] == 0 and _tf32["saved"]:
                torch.backends.cuda.matmul.allow_tf32 = True


def _eigh(mat: torch.Tensor, host: Optional[bool]):
    """(eigenvalues ascending, eigenvectors as columns), fp32 on
    ``mat.device``."""
    if host is None:
        host = mat.shape[0] >= _HOST_EIGH_THRESHOLD
    if host:
        vals, vecs = np.linalg.eigh(mat.cpu().numpy().astype(np.float64))
        return (torch.from_numpy(vals.astype(np.float32)).to(mat.device),
                torch.from_numpy(vecs.astype(np.float32)).to(mat.device))
    return torch.linalg.eigh(mat)


class PCAWhitener(NamedTuple):
    components: torch.Tensor  # (k, D)
    mean: torch.Tensor  # (D,)
    explained_variance: torch.Tensor  # (k,)

    def transform(self, x) -> torch.Tensor:
        """sklearn ``PCA(whiten=True).transform``: (N, D) array or tensor
        (float16 dumps are widened) -> (N, k) fp32 on the fit's device."""
        x = torch.as_tensor(x).to(self.mean.device, torch.float32)
        with fp32_matmuls():
            return ((x - self.mean) @ self.components.T) / torch.sqrt(self.explained_variance)


def fit_pca(features, n_components: int, host_eigh: Optional[bool] = None,
            device: Optional[str | torch.device] = None) -> PCAWhitener:
    """Fit on (N, D) ``features`` (an array or a tensor) on ``device``:
    default the tensor's own device, and the card for an array."""
    if device is None:
        device = features.device if torch.is_tensor(features) else "cuda"
    x = torch.as_tensor(features).to(resolve_device(device), torch.float32)
    n, d = x.shape
    mean = x.mean(dim=0)
    xc = x - mean
    k = min(n_components, min(n, d))
    with fp32_matmuls():
        if n <= d:
            eigvals, eigvecs = _eigh(xc @ xc.T, host_eigh)  # ascending
            eigvals = eigvals.flip(0)[:k]
            u = eigvecs.flip(1)[:, :k]  # (n, k)
            s = torch.sqrt(torch.clamp(eigvals, min=1e-12))
            comps = (xc.T @ (u / s)).T  # (k, d) right singular vectors
        else:
            eigvals, eigvecs = _eigh(xc.T @ xc, host_eigh)
            eigvals = eigvals.flip(0)[:k]
            comps = eigvecs.flip(1)[:, :k].T.contiguous()
            s = torch.sqrt(torch.clamp(eigvals, min=1e-12))
    explained = torch.clamp(s**2 / max(n - 1, 1), min=1e-12)
    return PCAWhitener(components=comps, mean=mean, explained_variance=explained)


def whiten_features(fit_on, transform, n_components: int,
                    device: Optional[str | torch.device] = None) -> torch.Tensor:
    return fit_pca(fit_on, n_components, device=device).transform(transform)
