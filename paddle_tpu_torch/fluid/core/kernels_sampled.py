"""Sampled-softmax-family kernels: NCE and hierarchical sigmoid
(counterpart of paddle_tpu/fluid/core/kernels_sampled.py).

Parity: reference operators/nce_op.{h,cc} (uniform negative sampling,
per-sample logistic loss) and operators/hierarchical_sigmoid_op
(gserver HierarchicalSigmoidLayer), whose code table is the complete
binary tree over `num_classes` leaves addressed by (label +
num_classes) bit paths (framework MatrixBitCodeFunctor semantics).

Sampling draws from the run's counter-derived key (`ctx.next_key()`)
through the port's threefry (utils/prng.py), bit for bit the JAX
package's draws, so `SampleLabels` agree across the two packages and
across the CPU and the card. The rest is dense batched math with
autograd gradients, including the gathers from the class matrices.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...utils import prng
from .registry import register_op

__all__ = []


@register_op("nce")
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation loss (reference nce_op.h NCEKernel):
    one logistic term for each true class + num_neg_samples noise
    classes per example, drawn uniformly or from `neg_distribution`."""
    x = ins["Input"][0]  # [N, D]
    label = ins["Label"][0]  # [N, num_true]
    w = ins["Weight"][0]  # [V, D]
    b = ins["Bias"][0] if ins.get("Bias") else None  # [V, 1]
    num_total = int(attrs["num_total_classes"])
    k = int(attrs.get("num_neg_samples", 10))
    N = x.shape[0]
    num_true = label.shape[1] if label.dim() > 1 else 1
    label = label.reshape(N, num_true).long()

    neg_dist = attrs.get("neg_distribution")
    if neg_dist and len(neg_dist) != num_total:
        raise ValueError(
            "neg_distribution has %d entries but num_total_classes is %d"
            % (len(neg_dist), num_total))
    key = ctx.next_key()
    if neg_dist:
        # legacy NCELayer custom distribution (MultinomialSampler): noise
        # ids drawn ~ dist, and the NCE noise prob becomes k * q(id)
        dist = torch.tensor(neg_dist, dtype=torch.float32, device=x.device)
        dist = dist / torch.sum(dist)
        samples = prng.categorical(key, torch.log(dist)[None, :],
                                   shape=(N, k))
    else:
        # the reference's default uniform Sampler
        samples = prng.randint(key, (N, k), 0, num_total)
    all_ids = torch.cat([label, samples.long()], dim=1)  # [N, T+k]
    flat = all_ids.reshape(-1)
    logits = torch.einsum("nd,nkd->nk", x,
                          w.index_select(0, flat).reshape(N, -1, w.shape[1]))
    if b is not None:
        logits = logits + b.reshape(-1).index_select(0, flat).reshape(N, -1)

    # Reference formulation (nce_op.h:93,115-133): o = sigmoid(s),
    # b = num_neg_samples / num_total_classes; true-class cost
    # -log(o/(o+b)), sampled-class cost -log(b/(o+b)); summed (NOT
    # averaged over num_true). Stable forms: -log(o/(o+b)) =
    # log(o+b) + softplus(-s); -log(b/(o+b)) = log(o+b) - log(b).
    s = logits.float()
    o = torch.sigmoid(s)
    if neg_dist:
        # clamp: a zero-probability class can still appear as a TRUE
        # label; its (masked-out) noise term must not produce log(0)
        noise_b = torch.clamp_min(k * dist[all_ids], 1e-20)  # [N, T+k]
    else:
        noise_b = torch.full((), k / num_total, dtype=torch.float32,
                             device=x.device)
    log_opb = torch.log(o + noise_b)
    true_cost = log_opb + F.softplus(-s)
    neg_cost = log_opb - torch.log(noise_b)
    lbl_mask = torch.cat([torch.ones(N, num_true, device=x.device),
                          torch.zeros(N, k, device=x.device)], dim=1)
    loss = torch.sum(lbl_mask * true_cost + (1.0 - lbl_mask) * neg_cost,
                     dim=1, keepdim=True)
    if ins.get("SampleWeight"):
        loss = loss * ins["SampleWeight"][0].reshape(N, 1)
    return {
        "Cost": loss.to(x.dtype),
        # the reference stores the POST-sigmoid activations here
        # (nce_op.h:115)
        "SampleLogits": o.to(x.dtype),
        "SampleLabels": all_ids,
    }


@register_op("hierarchical_sigmoid")
def _hsigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over the complete binary tree (reference
    hierarchical_sigmoid_op.h + MatrixBitCodeFunctor: node ids follow the
    heap addressing code = label + num_classes, walking up by halving;
    bit = code & 1 at each level)."""
    x = ins["X"][0]  # [N, D]
    w = ins["W"][0]  # [num_classes - 1, D]
    label = ins["Label"][0].reshape(-1).long()  # [N]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    C = int(attrs["num_classes"])
    N = x.shape[0]
    max_depth = max(1, math.ceil(math.log2(C)))

    # walk from the leaf (heap index label + C) up: at each level the
    # parent's row of w (heap index - 1; the root, heap 1, is row 0),
    # and the bit saying which child the path came from
    losses = torch.zeros(N, dtype=torch.float32, device=x.device)
    cur = label + C
    for _ in range(max_depth):
        parent = cur // 2
        bit = (cur & 1).float()  # 1 if right child
        row = torch.clamp(parent - 1, 0, C - 2)
        logit = torch.einsum("nd,nd->n", x, w.index_select(0, row))
        if bias is not None:
            logit = logit + bias.reshape(-1).index_select(0, row)
        # sigmoid cross entropy with target = bit, on the levels that
        # have an internal node (a shallower leaf has fewer)
        term = F.softplus(logit) - bit * logit
        losses = losses + torch.where(parent >= 1, term,
                                      torch.zeros_like(term))
        cur = parent
    # the reference's cache output
    pre_out = torch.zeros((N, max_depth), dtype=x.dtype, device=x.device)
    return {"Out": losses.reshape(N, 1).to(x.dtype), "PreOut": pre_out}
