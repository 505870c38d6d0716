"""Evaluators: metric accumulation across minibatches (a copy of
paddle_tpu/fluid/evaluator.py; reference python/paddle/v2/fluid/evaluator.py
and the legacy paddle/gserver/evaluators/).

The states of `Accuracy` and `ChunkEvaluator` are persistable scope
tensors that ops of the training step update on the executor's device;
`reset` zeroes them where they live and `eval` reads them back to the
host. `DetectionMAP` accumulates fetched detections on the host."""

from __future__ import annotations

import numpy as np
import torch

from . import layers
from .core.program import unique_name
from .executor import as_numpy, global_scope
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["Accuracy", "ChunkEvaluator", "DetectionMAP", "Evaluator"]


def _scalar(scope, var):
    return float(as_numpy(scope.get(var.name)).reshape(-1)[0])


class Evaluator(object):
    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Zero every state, on the device that holds it (a state the
        startup program has not made yet starts on the host)."""
        scope = global_scope()
        for var in self.states:
            old = scope.get(var.name) if var.name in scope else None
            if isinstance(old, torch.Tensor):
                scope.set(var.name, torch.zeros_like(old))
            else:
                scope.set(var.name, np.zeros(var.shape, var.dtype))

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_global_variable(
            name=unique_name(self.helper.name + "_" + suffix),
            persistable=True,
            dtype=dtype,
            shape=shape,
        )
        self.helper.set_variable_initializer(state, Constant(0.0))
        self.states.append(state)
        return state


class Accuracy(Evaluator):
    """Streaming accuracy (reference evaluator.py Accuracy)."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        main_program = self.helper.main_program
        if main_program.current_block_idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total = self.create_state(dtype="int64", shape=[1], suffix="total")
        self.correct = self.create_state(dtype="int64", shape=[1], suffix="correct")
        total = self.helper.create_tmp_variable(dtype="int64")
        correct = self.helper.create_tmp_variable(dtype="int64")
        acc = layers.accuracy(input=input, label=label, k=k, correct=correct, total=total)
        self.helper.append_op(
            type="sum",
            inputs={"X": [self.total, total]},
            outputs={"Out": [self.total]},
        )
        self.helper.append_op(
            type="sum",
            inputs={"X": [self.correct, correct]},
            outputs={"Out": [self.correct]},
        )
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        scope = global_scope()
        total = _scalar(scope, self.total)
        correct = _scalar(scope, self.correct)
        return np.array(correct / total if total else 0.0, dtype=np.float32)


class ChunkEvaluator(Evaluator):
    """Streaming chunk precision/recall/F1 (reference evaluator.py
    ChunkEvaluator; per-batch counts from layers.chunk_eval accumulated in
    persistable state vars)."""

    def __init__(
        self, input, label, chunk_scheme, num_chunk_types,
        excluded_chunk_types=None,
    ):
        super().__init__("chunk_eval")
        main_program = self.helper.main_program
        if main_program.current_block_idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")
        self.num_infer_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_infer_chunks"
        )
        self.num_label_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_label_chunks"
        )
        self.num_correct_chunks = self.create_state(
            dtype="int64", shape=[1], suffix="num_correct_chunks"
        )
        precision, recall, f1, num_infer, num_label, num_correct = (
            layers.chunk_eval(
                input=input,
                label=label,
                chunk_scheme=chunk_scheme,
                num_chunk_types=num_chunk_types,
                excluded_chunk_types=excluded_chunk_types,
            )
        )
        for state, batch in (
            (self.num_infer_chunks, num_infer),
            (self.num_label_chunks, num_label),
            (self.num_correct_chunks, num_correct),
        ):
            self.helper.append_op(
                type="sum", inputs={"X": [state, batch]}, outputs={"Out": [state]}
            )
        self.metrics.extend((precision, recall, f1))

    def eval(self, executor, eval_program=None):
        scope = global_scope()
        infer = _scalar(scope, self.num_infer_chunks)
        label = _scalar(scope, self.num_label_chunks)
        correct = _scalar(scope, self.num_correct_chunks)
        precision = correct / infer if infer else 0.0
        recall = correct / label if label else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if correct
            else 0.0
        )
        return np.array([precision, recall, f1], dtype=np.float32)


class DetectionMAP(object):
    """VOC-style mean Average Precision over detection outputs
    (reference gserver/evaluators/DetectionMAPEvaluator.cpp and fluid
    operators/detection_map_op.cc).

    Host-side accumulator by design: matching ragged per-image detection
    lists against ragged ground truth is control-flow-heavy host work in
    the reference too (a CPU evaluator fed from the device). Feed it the
    fetched `multiclass_nms` rows per image.

    detections per image: [k, 6] rows = [label, score, x1, y1, x2, y2]
    ground truth per image: boxes [m, 4], labels [m], difficult [m] bool.
    """

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=False,
                 ap_version="integral"):
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self.overlap_threshold = float(overlap_threshold)
        self.evaluate_difficult = bool(evaluate_difficult)
        self.ap_version = ap_version
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._scored = {}    # class -> [(score, is_tp)]
        self._gt_count = {}  # class -> #non-difficult gt boxes

    @staticmethod
    def _iou(box, boxes):
        x1 = np.maximum(box[0], boxes[:, 0])
        y1 = np.maximum(box[1], boxes[:, 1])
        x2 = np.minimum(box[2], boxes[:, 2])
        y2 = np.minimum(box[3], boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        a = (box[2] - box[0]) * (box[3] - box[1])
        b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        union = a + b - inter
        return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)

    def update(self, detections, gt_boxes, gt_labels, difficult=None):
        """One batch: each argument is a list with one entry per image."""
        n = len(detections)
        if difficult is None:
            difficult = [np.zeros(len(np.atleast_1d(l)), bool)
                         for l in gt_labels]
        for i in range(n):
            det = np.asarray(detections[i], np.float64).reshape(-1, 6)
            boxes = np.asarray(gt_boxes[i], np.float64).reshape(-1, 4)
            labels = np.asarray(gt_labels[i]).reshape(-1).astype(int)
            diff = np.asarray(difficult[i], bool).reshape(-1)
            for c in np.unique(labels):
                count = int(np.sum((labels == c) & ~diff))
                if self.evaluate_difficult:
                    count = int(np.sum(labels == c))
                self._gt_count[c] = self._gt_count.get(c, 0) + count
            # match per class, best score first (VOC protocol)
            det = det[det[:, 0] >= 0]  # drop padding rows
            order = np.argsort(-det[:, 1], kind="stable")
            matched = np.zeros(len(labels), bool)
            for j in order:
                c = int(det[j, 0])
                score = float(det[j, 1])
                cand = np.nonzero(labels == c)[0]
                bucket = self._scored.setdefault(c, [])
                if cand.size == 0:
                    bucket.append((score, False))
                    continue
                ious = self._iou(det[j, 2:6], boxes[cand])
                best = int(np.argmax(ious))
                gt_idx = cand[best]
                if ious[best] >= self.overlap_threshold:
                    if diff[gt_idx] and not self.evaluate_difficult:
                        continue  # matched a difficult gt: ignore
                    if not matched[gt_idx]:
                        matched[gt_idx] = True
                        bucket.append((score, True))
                    else:
                        bucket.append((score, False))  # duplicate
                else:
                    bucket.append((score, False))

    def _ap(self, scored, n_gt):
        if n_gt == 0:
            return None
        if not scored:
            return 0.0
        arr = np.asarray(sorted(scored, key=lambda t: -t[0]), np.float64)
        tp = np.cumsum(arr[:, 1])
        fp = np.cumsum(1.0 - arr[:, 1])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-12)
        if self.ap_version == "11point":
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t]
                ap += (p.max() if p.size else 0.0) / 11.0
            return float(ap)
        # integral: sum precision * delta-recall over detections
        prev_r = np.concatenate([[0.0], recall[:-1]])
        return float(np.sum(precision * (recall - prev_r)))

    def eval(self, executor=None, eval_program=None):
        """mAP over classes that have ground truth."""
        aps = []
        for c, n_gt in self._gt_count.items():
            ap = self._ap(self._scored.get(c, []), n_gt)
            if ap is not None:
                aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
