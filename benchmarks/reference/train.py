"""The training reference: the wms loss (the paper's soft, geometrically
weighted multi-similarity loss with MS mining), and three Adam steps of the
fp32 network from the same initial weights on the same batches."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from benchmarks.reference.model import descriptor_fp32, full_fp32, l2_normalize


def wms_loss(geo: torch.Tensor, emb: torch.Tensor, d_alpha: float, d_beta: float,
             alpha: float = 2.0, beta: float = 50.0, lamb: float = 1.0,
             eps: float = 0.1) -> torch.Tensor:
    """Soft weights w+ = sigmoid(-d_alpha (d - d_beta)), w- = sigmoid(-d_alpha
    (d_beta - d)) of the (B, B) metric distances in place of MS's binary
    masks; MS mining keeps positives harder than the hardest negative - eps
    and negatives harder than the easiest positive + eps (the thresholds
    pass no gradient)."""
    e = l2_normalize(emb)
    b = e.shape[0]
    zero = torch.zeros((), dtype=e.dtype, device=e.device)
    mask_pos = torch.sigmoid(-d_alpha * (geo - d_beta)) - torch.eye(b, dtype=e.dtype,
                                                                     device=e.device)
    mask_neg = torch.sigmoid(-d_alpha * (d_beta - geo))
    sim = torch.maximum(e @ e.T, zero)
    pos_mat, neg_mat = sim * mask_pos, sim * mask_neg
    max_val = neg_mat.amax(dim=1, keepdim=True).detach()
    tmp_max = pos_mat.amax(dim=1, keepdim=True).detach()
    min_val = (((sim - tmp_max) * mask_pos).amin(dim=1, keepdim=True) + tmp_max).detach()
    mask_pos = torch.where(pos_mat < max_val + eps, mask_pos, zero)
    mask_neg = torch.where(neg_mat > min_val - eps, mask_neg, zero)
    pos_mat, neg_mat = sim * mask_pos, sim * mask_neg
    pos_exp = torch.where(mask_pos > 0, torch.exp(-alpha * (pos_mat - lamb)), zero)
    neg_exp = torch.where(mask_neg > 0, torch.exp(beta * (neg_mat - lamb)), zero)
    return (torch.log1p(pos_exp.sum(dim=1)) / alpha
            + torch.log1p(neg_exp.sum(dim=1)) / beta).mean()


def adam_steps(params0: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor,
               torch.Tensor]], lrs: Sequence[float], d_alpha: float, d_beta: float,
               fp8: bool = False, half: bool = False, negate: bool = False,
               betas=(0.9, 0.999), eps: float = 1e-8
               ) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Adam steps of the fp32 network on (images, geo) batches from
    ``params0``: (each step's loss, the first step's gradient, the parameters
    after the last step). ``fp8``: the forward's conv inputs and weights
    through float8 (the control). ``half``: the loss over the first half of
    each batch; ``negate``: each update applied the other way (faults, for
    the limits)."""
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    with full_fp32():
        for t, ((images, geo), lr) in enumerate(zip(batches, lrs), start=1):
            n = len(images) // 2 if half else len(images)
            loss = wms_loss(geo[:n, :n].float(), descriptor_fp32(p, images[:n], fp8), d_alpha,
                            d_beta)
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if grad1 is None:
                    grad1 = {k: g.clone() for k, g in zip(p, grads)}
                for (k, leaf), g in zip(p.items(), grads):
                    m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                    v2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                    m_hat = m[k] / (1 - betas[0] ** t)
                    v_hat = v2[k] / (1 - betas[1] ** t)
                    leaf.sub_((-lr if negate else lr) * m_hat / (v_hat.sqrt() + eps))
    return losses, grad1, {k: v.detach() for k, v in p.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    ref_n = {k: float(ref[k].double().norm()) for k in keep}
    median = float(torch.tensor(list(ref_n.values())).median())
    return {k: abs(float(prog[k].double().norm()) - ref_n[k]) / max(ref_n[k], median, 1e-30)
            for k in keep}


def sign_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Sequence[str]) -> Dict[str, float]:
    """Each leaf's share of its settled elements, those that the reference
    moved by at least half of the leaf's largest move, that the program
    moved the other way (or not at all)."""
    out = {}
    for k in keep:
        r = ref[k].double()
        mask = r.abs() >= 0.5 * float(r.abs().max())
        agree = (torch.sign(prog[k].double()[mask]) == torch.sign(r[mask])).double().mean()
        out[k] = 1.0 - float(agree)
    return out


def order_gap(order: Sequence[Sequence[int]], desc: torch.Tensor) -> float:
    """The largest amount by which a row's j-th neighbour in ``order`` (the
    rows of a neighbour order, as indices into ``desc``) lies farther, in
    squared distance between the reference's descriptors ``desc``, than the
    row's true j-th nearest."""
    d = desc.double()
    sq = ((d[:, None, :] - d[None, :, :]) ** 2).sum(-1)
    truth = sq.sort(dim=1).values
    gap = 0.0
    for a, row in enumerate(order):
        got = sq[a, torch.as_tensor(list(row), dtype=torch.long, device=sq.device)]
        gap = max(gap, float((got - truth[a, : len(row)]).max()))
    return gap


def own_order(desc: torch.Tensor) -> List[List[int]]:
    """The neighbour order of ``desc`` by its own squared distances."""
    d = desc.double()
    sq = ((d[:, None, :] - d[None, :, :]) ** 2).sum(-1)
    return sq.argsort(dim=1, stable=True).tolist()


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``) and its name."""
    gaps = leaf_gaps(prog, ref, keep)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def moving_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(g.double().norm()) for k, g in grad_ref.items()}
    median = float(torch.tensor(list(norms.values())).median())
    return [k for k, n in norms.items() if n > 1e-3 * median]
