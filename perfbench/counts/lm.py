"""Operations and bytes of a decoder-only LM's work, computed from its
shapes: what the inputs need, whatever kernel implements it.

`forward_flops` is the repo's long-standing LM count (matrix parameters
times two per token, the tied head once, causal attention's two products
over half the square); a training step is three times it. The flash
counts take each input read once and each output written once."""

from .peaks import least_s


def forward_flops(batch, seq, layers, dim, vocab, mlp_mult=4):
    """FLOPs of one forward pass over [batch, seq] tokens."""
    p_mat = vocab * dim + layers * (4 + 2 * mlp_mult) * dim * dim
    return 2.0 * batch * seq * p_mat + layers * batch * 2.0 * seq * seq * dim


def train_flops(batch, seq, layers, dim, vocab, mlp_mult=4):
    """Model FLOPs of one training step: forward and backward, 3x."""
    return 3.0 * forward_flops(batch, seq, layers, dim, vocab, mlp_mult)


def causal_pairs(batch, heads, seq):
    """(query, key) pairs one causal attention over [batch, seq] attends."""
    return batch * heads * seq * (seq + 1) // 2


def flash_forward(batch, seq, heads, head_dim, esize):
    """(flops, bytes) of causal attention's forward: S = QK^T and O = PV
    over the attended pairs; q, k, v read, o and the f32 row statistics
    written."""
    flops = 2.0 * head_dim * causal_pairs(batch, heads, seq) * 2
    act = batch * seq * heads * head_dim * esize
    rows = batch * heads * seq * 4
    return flops, 4 * act + rows


def flash_backward(batch, seq, heads, head_dim, esize):
    """(flops, bytes) of causal attention's backward from q, k, v, o, the
    output gradient and the row statistics: S recomputed once, dP = dO V^T,
    dV = P^T dO, dQ = dS K, dK = dS^T Q (five products); dq, dk, dv
    written."""
    flops = 2.0 * head_dim * causal_pairs(batch, heads, seq) * 5
    act = batch * seq * heads * head_dim * esize
    rows = batch * heads * seq * 4
    return flops, 5 * act + rows + 3 * act


def flash_step_least_s(batch, seq, heads, head_dim, esize, layers):
    """Least seconds of one training step's flash work: each layer's
    forward and backward, each at the larger of its two bounds."""
    f = least_s(*flash_forward(batch, seq, heads, head_dim, esize))
    b = least_s(*flash_backward(batch, seq, heads, head_dim, esize))
    return layers * (f + b)


def paged_step(contexts, heads, head_dim, kv_esize, q_rows=1, q_esize=2):
    """(flops, bytes) of one paged-attention launch over slots whose true
    context lengths are `contexts`: each slot's K and V rows attended read
    once at the pool's storage size, q read and the output written once
    (`q_rows` query rows a slot), 4 * head_dim flops per attended
    (row, head, position)."""
    kv = 0
    flops = 0.0
    for n in contexts:
        kv += 2 * n * heads * head_dim * kv_esize
        flops += 4.0 * head_dim * heads * n * q_rows
    qo = 2 * len(contexts) * q_rows * heads * head_dim * q_esize
    return flops, kv + qo
