"""The serving traffic's general generator: a fixed set of request sizes
read from a mix's parameters, put in an order drawn from the seed, with
prompt tokens drawn from the seed, arriving one every 1 / `rate`
seconds.

Every seed gets the same sizes and the same arrivals: prompt lengths at
the quantiles of a log-normal (`median`, `sigma`) clipped to [`min`,
`max`], output lengths spread evenly over [`min`, `max`] and paired with
the prompts by a fixed stride, so that the seed changes the order and
the tokens, never the work. Arrivals are evenly spaced: with random
gaps the seed moves the bursts, and with them the tail of the time to
first token, by more than two runs of one seed differ."""

import math
from statistics import NormalDist

import torch


def sizes(mix):
    """[(prompt_len, output_len)] of the mix's `requests` requests, in a
    fixed order."""
    n, p, o = mix["requests"], mix["prompt"], mix["output"]
    nd = NormalDist()
    prompts = [min(p["max"], max(p["min"], int(round(
        p["median"] * math.exp(p["sigma"] * nd.inv_cdf((i + 0.5) / n))))))
        for i in range(n)]
    outs = [o["min"] + int((o["max"] - o["min"]) * (i + 0.5) / n)
            for i in range(n)]
    stride = _coprime(n)
    return [(prompts[i], outs[(i * stride) % n]) for i in range(n)]


def _coprime(n):
    k = max(1, int(n * 0.618))
    while math.gcd(k, n) != 1:
        k += 1
    return k


def requests(mix, seed, vocab):
    """[(prompt token ids as a list, output_len)]: `sizes` in an order
    drawn from the seed, each prompt uniform over the vocabulary."""
    g = torch.Generator().manual_seed(int(seed) + 2)
    sz = sizes(mix)
    order = torch.randperm(len(sz), generator=g).tolist()
    total = sum(p for p, _ in sz)
    toks = torch.randint(0, vocab, (total,), generator=g).tolist()
    out, at = [], 0
    for i in order:
        p, o = sz[i]
        out.append((toks[at:at + p], o))
        at += p
    return out


def gaps(mix):
    """Seconds between arrivals: 1 / `rate`, `requests` of them."""
    return [1.0 / mix["rate"]] * mix["requests"]
