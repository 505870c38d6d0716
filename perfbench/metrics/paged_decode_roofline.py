"""paged_decode_roofline: the least time of the traced slice's decode
attention (every output token's K and V rows over its true context read
once at the pool's storage size, its q read and its output written once,
counts/lm.py) over the device time of the port's split-context paged
kernel launched one query row a slot (paged_split_kernel<TQ, TP, 1,
...>, csrc/paged_attention.cu), in %."""

from perfbench.counts.peaks import least_s


def _decode_split(name):
    head = "paged_split_kernel<"
    if head not in name:
        return False
    args = name.split(head, 1)[1].split(">", 1)[0].split(",")
    return len(args) >= 3 and args[2].strip() == "1"


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or not c.get("slice_decode_tokens"):
        return None
    spent = ctx.trace.device_s(_decode_split)
    if spent <= 0:
        return None
    return 100.0 * least_s(c["slice_decode_flops"],
                           c["slice_decode_bytes"]) / spent
