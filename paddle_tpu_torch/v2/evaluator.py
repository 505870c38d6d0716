"""paddle.v2.evaluator: metric layers attached via SGD(extra_layers=...)
(reference python/paddle/v2/evaluator.py auto-wrapping
trainer_config_helpers/evaluators.py; e.g. classification_error_evaluator
at evaluators.py:220).

Each evaluator is a lazy DSL Layer that Topology lowers to a fluid metric
op; trainer.SGD fetches it per batch and delivers the value in the
event.evaluator payload keyed by the evaluator's name — matching the
reference book-style `event.evaluator` access pattern.
"""

from __future__ import annotations

from .layer import Layer, _as_list

__all__ = ["classification_error", "auc", "sum", "column_sum"]


def classification_error(input, label, name=None, top_k=1, **kwargs):
    """Fraction of mis-classified instances in the batch (reference
    classification_error_evaluator)."""
    return Layer("classification_error_evaluator", name,
                 _as_list(input) + _as_list(label), {"top_k": top_k})


def auc(input, label, name=None, **kwargs):
    """Area under the ROC curve over the batch (reference auc_evaluator)."""
    return Layer("auc_evaluator", name, _as_list(input) + _as_list(label), {})


def sum(input, name=None, **kwargs):  # noqa: A001 - reference name
    """Sum of the input over the batch (reference sum_evaluator)."""
    return Layer("sum_evaluator", name, _as_list(input), {})


def column_sum(input, name=None, **kwargs):
    """Per-column sum of the input (reference column_sum_evaluator)."""
    return Layer("column_sum_evaluator", name, _as_list(input), {})


def precision_recall(input, label, positive_label=None, name=None,
                     **kwargs):
    """Macro F1 (or the positive class's F1) over the batch (reference
    precision_recall_evaluator)."""
    return Layer("precision_recall_evaluator", name,
                 _as_list(input) + _as_list(label),
                 {"positive_label": positive_label})


def ctc_error(input, label, name=None, **kwargs):
    """Normalised edit distance of the CTC greedy decode (reference
    ctc_error_evaluator)."""
    return Layer("ctc_error_evaluator", name,
                 _as_list(input) + _as_list(label), {})


def chunk(input, label, chunk_scheme, num_chunk_types, name=None,
          excluded_chunk_types=None, **kwargs):
    """Chunking F1 (reference chunk_evaluator)."""
    return Layer("chunk_evaluator", name,
                 _as_list(input) + _as_list(label), {
                     "chunk_scheme": chunk_scheme,
                     "num_chunk_types": num_chunk_types,
                     "excluded_chunk_types": excluded_chunk_types,
                 })


def detection_map(input, label, overlap_threshold=0.5, num_classes=None,
                  name=None, **kwargs):
    """Per-batch VOC mAP (reference detection_map_evaluator)."""
    return Layer("detection_map_evaluator", name,
                 _as_list(input) + _as_list(label), {
                     "overlap_threshold": overlap_threshold,
                     "background_id": 0, "num_classes": num_classes,
                 })


__all__ += ["precision_recall", "ctc_error", "chunk", "detection_map"]
