"""Weights and inputs made from the run's seed, on the device, in the
type they are served in: a few large random draws, then split. The
benchmark hands the same values to the program and to the reference."""

import math

import torch


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def gpt2_layout(c):
    """(name, shape, std) of a GPT-2-shaped decoder's leaves in the
    port's tree order: the embedding and positions, per block ln1, wq,
    wk, wv, wo, ln2, w1, w2, then ln_f. std 0 marks a LayerNorm bias,
    None a LayerNorm gain (ones); the residual projections (wo, w2) are
    scaled by 1/sqrt(2 * layers) as GPT-2 initialises them."""
    d, m = c["n_embd"], c["n_inner"] or 4 * c["n_embd"]
    s, L = c["initializer_range"], c["n_layer"]
    r = s / math.sqrt(2 * L)
    out = [("embed", (c["vocab_size"], d), s), ("pos", (c["n_positions"], d), s)]
    for i in range(L):
        b = "blocks.%d." % i
        out += [(b + "ln1.g", (d,), None), (b + "ln1.b", (d,), 0.0),
                (b + "wq", (d, d), s), (b + "wk", (d, d), s),
                (b + "wv", (d, d), s), (b + "wo", (d, d), r),
                (b + "ln2.g", (d,), None), (b + "ln2.b", (d,), 0.0),
                (b + "w1", (d, m), s), (b + "w2", (m, d), r)]
    return out + [("ln_f.g", (d,), None), ("ln_f.b", (d,), 0.0)]


def gpt2_flat(c, seed, device, dtype):
    """[(name, tensor)] in `gpt2_layout` order: one normal draw for every
    random leaf, split and scaled."""
    lay = gpt2_layout(c)
    n = sum(math.prod(shape) for _, shape, std in lay if std)
    with torch.no_grad():
        big = torch.randn(n, generator=generator(seed, device),
                          device=device, dtype=dtype)
        out, at = [], 0
        for name, shape, std in lay:
            if std is None:
                t = torch.ones(shape, device=device, dtype=dtype)
            elif std == 0.0:
                t = torch.zeros(shape, device=device, dtype=dtype)
            else:
                k = math.prod(shape)
                t = big[at:at + k].view(shape).mul(std)
                at += k
            out.append((name, t))
    return out


def to_tree(flat):
    """The port's parameter tree {"embed", "pos", "blocks": [...],
    "ln_f"} from `gpt2_flat`'s list (the same tensors)."""
    tree = {"blocks": []}
    for name, t in flat:
        parts = name.split(".")
        if parts[0] == "blocks":
            i = int(parts[1])
            while len(tree["blocks"]) <= i:
                tree["blocks"].append({})
            node, rest = tree["blocks"][i], parts[2:]
        else:
            node, rest = tree, parts
        for p in rest[:-1]:
            node = node.setdefault(p, {})
        node[rest[-1]] = t
    return tree


def token_batches(seed, n, batch, seq, vocab, device):
    """[n, batch, seq + 1] token ids, uniform over the vocabulary, from a
    draw of its own (the weights' seed plus one)."""
    g = generator(int(seed) + 1, device)
    return torch.randint(0, vocab, (n, batch, seq + 1), generator=g,
                         device=device)


def resnet_flat(lay, seed, device):
    """float32 leaves for a `reference.resnet50.layout`: one normal draw
    for the convolutions (He: std sqrt(2 / fan_in)) and the fully
    connected weight (std sqrt(1 / fan_in)); batch-norm scales 1, biases
    and the fc bias 0."""
    n = sum(math.prod(s["shape"]) for s in lay
            if s["kind"] in ("conv", "fc_w"))
    with torch.no_grad():
        big = torch.randn(n, generator=generator(seed, device),
                          device=device)
        out, at = [], 0
        for s in lay:
            shape = s["shape"]
            if s["kind"] in ("conv", "fc_w"):
                k = math.prod(shape)
                fan_in = k // shape[0] if s["kind"] == "conv" else shape[0]
                gain = 2.0 if s["kind"] == "conv" else 1.0
                out.append(big[at:at + k].view(shape).mul(
                    math.sqrt(gain / fan_in)))
                at += k
            elif s["kind"] == "bn_scale":
                out.append(torch.ones(shape, device=device))
            else:
                out.append(torch.zeros(shape, device=device))
    return out


def image_batches(seed, n, batch, shape, classes, device):
    """n (images [batch, *shape] uniform in [0, 1), labels [batch, 1]
    int64) pairs from a draw of their own (the weights' seed plus one)."""
    g = generator(int(seed) + 1, device)
    imgs = torch.rand((n, batch) + tuple(shape), generator=g, device=device)
    labs = torch.randint(0, classes, (n, batch, 1), generator=g,
                         device=device)
    return [(imgs[i], labs[i]) for i in range(n)]
