"""Autograd around the hand-written kernels.

A kernel writes its output through raw pointers and records no graph. Each
kernel that needs a gradient has an ``autograd.Function`` whose forward
launches it. K3's backward is autograd of the plain PyTorch formula,
recomputed from the saved inputs (``plain_backward``): the split the JAX
package's custom_vjp makes (``wms_loss_fused``). K4's is autograd of the
direct conv (``ops/kernels/winograd.py``); K1's is a kernel of its own
(``ops/kernels/netvlad.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def refuse_graph(what: str, function: str, *tensors: torch.Tensor) -> None:
    """Raise when a bare kernel call would silently cut a graph: grad mode
    on and an input that requires grad. Inside ``function``'s forward grad
    mode is off, so the check passes there and the Function supplies the
    backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} records no autograd graph; call it through {function} "
            "to differentiate, or under torch.no_grad()")


def plain_backward(plain: Callable[..., torch.Tensor], saved: Sequence[torch.Tensor],
                   needs: Sequence[bool], grad: torch.Tensor, *args) -> tuple:
    """Gradients of ``plain(*saved, *args)`` for the saved tensors whose
    ``needs`` flag is set (None for the others)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*inputs, *args)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)
