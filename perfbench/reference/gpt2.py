"""GPT-2's decoder in plain PyTorch float32: the reference of the
`gpt2_medium` configuration (Radford et al. 2019), with the departures
its configuration file lists (no biases in the attention and MLP
projections, no dropout). It imports nothing of the program.

Pre-LayerNorm blocks (eps 1e-5, biased variance), learned positions,
multi-head causal attention scaled by 1/sqrt(head_dim), a tanh-GELU MLP
of 4x width, a final LayerNorm and an output head tied to the embedding;
the loss is next-token cross entropy averaged over every position.

`train_readings` runs SGD steps from given weights and reports what the
benchmark compares: each step's loss, each leaf's first gradient as the
parameters' change after one step over the rate, and each leaf's change
after the last step. The parameters are stored in the configuration's
dtype between steps (`store`), as its SGD step stores them: every update
lr * g is rounded to that dtype, and so is the updated parameter. All
arithmetic is float32 with TF32 off; `mm` swaps the matrix product and
`act` is applied to the residual stream after every sum (the control
passes fp8 ones: with the products' operands, those are the tensors the
program keeps in bfloat16). The batch is taken `rows` rows at a time and
the gradients summed, which is the same mean over every position."""

import math

import torch
import torch.nn.functional as F


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def _same(x):
    return x


def logits(w, tokens, heads, mm=torch.matmul, act=_same):
    """tokens [B, T] -> logits [B, T, vocab]; `w` maps leaf names to
    float32 tensors."""
    B, T = tokens.shape
    d = w["embed"].shape[1]
    dh = d // heads
    x = act(w["embed"][tokens] + w["pos"][:T][None])
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    i = 0
    while "blocks.%d.wq" % i in w:
        p = lambda n: w["blocks.%d.%s" % (i, n)]  # noqa: E731
        h = _ln(x, p("ln1.g"), p("ln1.b"))
        q, k, v = (mm(h, p(n)).reshape(B, T, heads, dh).transpose(1, 2)
                   for n in ("wq", "wk", "wv"))
        s = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
        a = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        o = mm(a, v).transpose(1, 2).reshape(B, T, d)
        x = act(x + mm(o, p("wo")))
        h = _ln(x, p("ln2.g"), p("ln2.b"))
        x = act(x + mm(F.gelu(mm(h, p("w1")), approximate="tanh"),
                       p("w2")))
        i += 1
    x = _ln(x, w["ln_f.g"], w["ln_f.b"])
    return mm(x, w["embed"].transpose(0, 1))


def loss_and_grads(names, leaves, tokens, heads, mm=torch.matmul, rows=2,
                   act=_same):
    """(mean next-token loss over tokens [B, T + 1], gradients of
    `leaves`), `rows` rows of the batch at a time."""
    B = tokens.shape[0]
    total = 0.0
    grads = [torch.zeros_like(p) for p in leaves]
    for lo in range(0, B, rows):
        part = tokens[lo:lo + rows]
        ps = [p.detach().requires_grad_(True) for p in leaves]
        z = logits(dict(zip(names, ps)), part[:, :-1], heads, mm, act)
        nll = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                              part[:, 1:].reshape(-1))
        loss = nll * (part.shape[0] / B)
        for acc, g in zip(grads, torch.autograd.grad(loss, ps)):
            acc.add_(g)
        total += float(loss.detach())
        del z, nll, loss, ps
    return total, grads


def train_readings(flat, batches, lr, heads, store, mm=torch.matmul,
                   rows=2, act=_same):
    """Readings of len(batches) SGD steps from `flat` [(name, tensor)]:
    {"loss": [per step], "grad_norms": [per leaf], "change_norms": [per
    leaf], "keep_norms": [per leaf, the first gradient's norm before it is
    stored, which decides the leaves compared]} (float32 norms on the
    weights' device)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        names = [n for n, _ in flat]
        p = [t.detach().float() for _, t in flat]
        p0 = [t.clone() for t in p]
        losses, grad_norms, keep_norms = [], None, None
        for k, toks in enumerate(batches):
            loss, grads = loss_and_grads(names, p, toks, heads, mm, rows,
                                         act)
            losses.append(loss)
            if k == 0:
                keep_norms = torch.stack([g.norm() for g in grads])
            with torch.no_grad():
                for x, g in zip(p, grads):
                    upd = (lr * g).to(store).float()
                    x.copy_((x - upd).to(store).float())
            del grads
            if k == 0:
                grad_norms = torch.stack([(a - b).norm() / lr
                                          for a, b in zip(p0, p)])
        change = torch.stack([(b - a).norm() for a, b in zip(p0, p)])
        return {"loss": losses, "grad_norms": grad_norms,
                "change_norms": change, "keep_norms": keep_norms}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
