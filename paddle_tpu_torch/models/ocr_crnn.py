"""CRNN OCR model (a copy of paddle_tpu/models/ocr_crnn.py built on the
port's fluid layers): conv feature extractor -> columns as a sequence ->
bidirectional GRU encoder -> CTC. im2sequence emits the LoD side-band
(static offsets, known to the host), the GRUs run as masked loops over
time, CTC is the log-space recursion of core/kernels_ctc.py."""

from __future__ import annotations

from ..fluid import layers

__all__ = ["crnn_ctc", "ctc_infer", "greedy_decode"]


def _conv_pool(input, filters, channels):
    y = layers.conv2d(
        input=input, num_filters=filters, filter_size=3, padding=1,
        num_channels=channels, act="relu",
    )
    return layers.pool2d(input=y, pool_size=2, pool_stride=2)


def _encode(images, num_classes, hidden=48):
    """images [N, 1, H, W] -> per-column class logits (packed sequence
    rows with LoD) sized num_classes+1 (CTC blank is the last id)."""
    y = _conv_pool(images, 16, int(images.shape[1]))
    y = _conv_pool(y, 32, 16)
    h = int(y.shape[2])
    # every output column = one time step: kernel spans the full height
    seq = layers.im2sequence(y, filter_size=[h, 1], stride=[1, 1])
    fc = layers.fc(input=seq, size=hidden, act="relu")
    fwd = layers.dynamic_gru(input=layers.fc(input=fc, size=hidden * 3),
                             size=hidden)
    bwd = layers.dynamic_gru(input=layers.fc(input=fc, size=hidden * 3),
                             size=hidden, is_reverse=True)
    both = layers.concat([fwd, bwd], axis=1)
    return layers.fc(input=both, size=num_classes + 1)


def crnn_ctc(images, label, num_classes, hidden=48):
    """Training head: mean CTC loss over the batch. `label` is the
    packed int sequence [sum_len, 1] with its LoD."""
    logits = _encode(images, num_classes, hidden)
    cost = layers.warpctc(input=logits, label=label, blank=num_classes)
    return layers.mean(x=cost), logits


def greedy_decode(logits, num_classes):
    """Greedy CTC decode of `logits` (merge repeats, drop blanks).
    Build this in the SAME program as crnn_ctc and clone(for_test=True)
    before minimize() so serving shares the trained weights."""
    return layers.ctc_greedy_decoder(
        layers.softmax(logits), blank=num_classes
    )


def ctc_infer(images, num_classes, hidden=48):
    """Standalone serving graph (fresh parameters — load them via
    io.load_inference_model / parameter files)."""
    logits = _encode(images, num_classes, hidden)
    return greedy_decode(logits, num_classes)
