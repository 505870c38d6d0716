"""Evaluator DSL wrappers (reference
trainer_config_helpers/evaluators.py): metric nodes attached to the
config graph; the trainer fetches them per batch and v2.trainer.test()
accumulates them with the right semantics (weighted mean for ratio
metrics, running totals for sums — v2/trainer.py).

Each wrapper builds a lazy Layer node; v2/topology.py lowers it onto the
fluid metric kernels (accuracy, auc, precision_recall, chunk_eval,
edit_distance, detection_map, pnpair_eval).
"""

from __future__ import annotations

from ..v2.layer import Layer, _as_list

__all__ = [
    "evaluator_base",
    "classification_error_evaluator",
    "auc_evaluator",
    "pnpair_evaluator",
    "precision_recall_evaluator",
    "ctc_error_evaluator",
    "chunk_evaluator",
    "sum_evaluator",
    "column_sum_evaluator",
    "detection_map_evaluator",
    "value_printer_evaluator",
    "gradient_printer_evaluator",
    "maxid_printer_evaluator",
    "maxframe_printer_evaluator",
    "seqtext_printer_evaluator",
    "classification_error_printer_evaluator",
]


def classification_error_evaluator(input, label, name=None, top_k=1,
                                   **kwargs):
    """error = 1 - top_k accuracy (reference evaluators.py:220)."""
    return Layer("classification_error_evaluator", name,
                 _as_list(input) + _as_list(label), {"top_k": top_k})


def auc_evaluator(input, label, name=None, **kwargs):
    return Layer("auc_evaluator", name,
                 _as_list(input) + _as_list(label), {})


def sum_evaluator(input, name=None, **kwargs):
    return Layer("sum_evaluator", name, _as_list(input), {})


def column_sum_evaluator(input, name=None, **kwargs):
    return Layer("column_sum_evaluator", name, _as_list(input), {})


def precision_recall_evaluator(input, label, positive_label=None,
                               name=None, **kwargs):
    """Macro-averaged F1 over classes, or the positive class's F1 when
    `positive_label` is given (reference PrecisionRecallEvaluator)."""
    return Layer("precision_recall_evaluator", name,
                 _as_list(input) + _as_list(label),
                 {"positive_label": positive_label})


def pnpair_evaluator(input, label, query_id, weight=None, name=None,
                     **kwargs):
    """Within-query positive/negative pair ranking ratio (reference
    PnpairEvaluator); pairs weight by w_i * w_j when `weight` given."""
    parents = [_as_list(input)[0], _as_list(label)[0],
               _as_list(query_id)[0]]
    if weight is not None:
        parents.append(_as_list(weight)[0])
    return Layer("pnpair_evaluator", name, parents,
                 {"weighted": weight is not None})


def ctc_error_evaluator(input, label, name=None, **kwargs):
    """Normalised edit distance between the CTC greedy decode of `input`
    and `label` (reference CTCErrorEvaluator)."""
    return Layer("ctc_error_evaluator", name,
                 [_as_list(input)[0], _as_list(label)[0]], {})


def chunk_evaluator(input, label, chunk_scheme, num_chunk_types,
                    name=None, excluded_chunk_types=None, **kwargs):
    """Chunking F1 (reference ChunkEvaluator): decoded tag sequence vs
    label under an IOB/IOE/IOBES scheme."""
    return Layer("chunk_evaluator", name,
                 [_as_list(input)[0], _as_list(label)[0]], {
                     "chunk_scheme": chunk_scheme,
                     "num_chunk_types": num_chunk_types,
                     "excluded_chunk_types": excluded_chunk_types,
                 })


def detection_map_evaluator(input, label, overlap_threshold=0.5,
                            background_id=0, num_classes=None, name=None,
                            **kwargs):
    """Per-batch VOC mAP over detection_output rows (reference
    DetectionMAPEvaluator; graph form of fluid/evaluator.py
    DetectionMAP). `input` is a detection_output_layer node; `label`
    the ground-truth sequence ([class, x1, y1, x2, y2(, difficult)]
    rows per image)."""
    return Layer("detection_map_evaluator", name,
                 [_as_list(input)[0], _as_list(label)[0]], {
                     "overlap_threshold": overlap_threshold,
                     "background_id": background_id,
                     "num_classes": num_classes,
                 })


def evaluator_base(input, type=None, label=None, name=None, **kwargs):
    """Generic dispatch by evaluator type string (reference
    evaluator_base): routes onto the concrete wrappers above."""
    table = {
        "classification_error": classification_error_evaluator,
        "last-column-auc": auc_evaluator,
        "sum": sum_evaluator,
        "last-column-sum": column_sum_evaluator,
        "precision_recall": precision_recall_evaluator,
    }
    fn = table.get(type)
    if fn is None:
        raise ValueError("unknown evaluator type %r" % type)
    if label is not None:
        return fn(input=input, label=label, name=name, **kwargs)
    return fn(input=input, name=name, **kwargs)


def _printer(kind):
    def wrapper(input, name=None, **kwargs):
        return Layer(kind, name, _as_list(input), {})

    wrapper.__name__ = kind + "_evaluator"
    wrapper.__doc__ = (
        "Debug printer (reference %sPrinter): identity node whose value "
        "the trainer logs per batch — the fetch itself is the "
        "print." % kind
    )
    return wrapper


value_printer_evaluator = _printer("printer")
gradient_printer_evaluator = _printer("printer")
maxid_printer_evaluator = _printer("maxid_printer")
maxframe_printer_evaluator = _printer("printer")
classification_error_printer_evaluator = _printer("printer")


def seqtext_printer_evaluator(input, result_file, id_input=None,
                              dict_file=None, name=None, **kwargs):
    """Write generated id sequences as dictionary words to result_file
    (reference SequenceTextPrinter, evaluators.py:697 — result_file is
    the required second positional): the trainer CLI's generation job
    consumes the recorded (dict_file, result_file) pair after decoding
    (trainer/__init__.py run_config)."""
    from . import get_config_state

    if not isinstance(result_file, str):
        raise TypeError(
            "seqtext_printer_evaluator(input, result_file, ...): "
            "result_file must be a path string, got %r" % (result_file,)
        )
    if id_input is not None and isinstance(id_input, str):
        raise TypeError("id_input must be a layer, not a string")
    node = Layer("printer", name, _as_list(input), {})
    get_config_state().setdefault("seqtext_printers", []).append({
        "input": _as_list(input)[0].name,
        "id_input": _as_list(id_input)[0].name if id_input is not None
        else None,
        "dict_file": dict_file,
        "result_file": result_file,
    })
    return node
