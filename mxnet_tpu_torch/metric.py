"""Evaluation metrics (ref: python/mxnet/metric.py:1-416).

Updated host-side per batch like the reference (model.py:244); asnumpy() is
the sync point. Composite/custom/np variants included.
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError
from .ndarray import NDArray

__all__ = [
    "EvalMetric", "Accuracy", "TopKAccuracy", "F1", "Perplexity", "MAE", "MSE",
    "RMSE", "CrossEntropy", "CustomMetric", "Torch", "Caffe", "CompositeEvalMetric", "np", "create",
]


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        # more prediction heads than labels is legal: grouped nets carry
        # gradient-blocked auxiliary heads (CaffeLoss's NLL blob, MakeLoss
        # monitors) after the scored output, and the pairwise zip ignores
        # the surplus. Fewer preds than labels is a real wiring error.
        label_shape, pred_shape = len(labels), len(preds)
        if label_shape > pred_shape:
            raise ValueError(
                "%d labels but only %d prediction outputs"
                % (label_shape, pred_shape))
        return
    label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels %s does not match shape of predictions %s"
            % (label_shape, pred_shape)
        )


class EvalMetric:
    """ref: metric.py:22."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [
            x / y if y != 0 else float("nan")
            for x, y in zip(self.sum_metric, self.num_inst)
        ]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """ref: metric.py:85."""

    def __init__(self, **kwargs):
        super().__init__("composite")
        try:
            self.metrics = kwargs["metrics"]
        except KeyError:
            self.metrics = []

    def add(self, metric):
        self.metrics.append(metric)

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}".format(
                index, len(self.metrics)))

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        results = []
        for metric in self.metrics:
            result = metric.get()
            names.append(result[0])
            results.append(result[1])
        return (names, results)


class Accuracy(EvalMetric):
    """ref: metric.py:129."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred = pred_label.asnumpy()
            if pred.ndim > 1 and pred.shape[1] > 1:
                pred = _np.argmax(pred, axis=1)
            label = label.asnumpy().astype("int32")
            pred = pred.astype("int32").reshape(label.shape)
            check_label_shapes(label, pred, shape=1)
            self.sum_metric += (pred.flat == label.flat).sum()
            self.num_inst += len(pred.flat)


class TopKAccuracy(EvalMetric):
    """ref: metric.py:152."""

    def __init__(self, **kwargs):
        super().__init__("top_k_accuracy")
        try:
            self.top_k = kwargs["top_k"]
        except KeyError:
            self.top_k = 1
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            pred = _np.argsort(pred_label.asnumpy().astype("float32"), axis=1)
            label = label.asnumpy().astype("int32")
            check_label_shapes(label, pred)
            num_samples = pred.shape[0]
            num_dims = len(pred.shape)
            if num_dims == 1:
                self.sum_metric += (pred.flat == label.flat).sum()
            elif num_dims == 2:
                num_classes = pred.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pred[:, num_classes - 1 - j].flat == label.flat).sum()
            self.num_inst += num_samples


class F1(EvalMetric):
    """Binary F1 (ref: metric.py:189)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = pred.asnumpy()
            label = label.asnumpy().astype("int32")
            pred_label = _np.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(_np.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary classification.")
            true_positives, false_positives, false_negatives = 0.0, 0.0, 0.0
            for y_pred, y_true in zip(pred_label, label):
                if y_pred == 1 and y_true == 1:
                    true_positives += 1.0
                elif y_pred == 1 and y_true == 0:
                    false_positives += 1.0
                elif y_pred == 0 and y_true == 1:
                    false_negatives += 1.0
            if true_positives + false_positives > 0:
                precision = true_positives / (true_positives + false_positives)
            else:
                precision = 0.0
            if true_positives + false_negatives > 0:
                recall = true_positives / (true_positives + false_negatives)
            else:
                recall = 0.0
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.0
            self.sum_metric += f1_score
            self.num_inst += 1


class Perplexity(EvalMetric):
    """ref: metric.py:248."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.asnumpy().reshape(-1).astype("int32")
            pred = pred.asnumpy()
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[_np.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(prob.dtype)
                num -= int(_np.sum(ignore))
                prob = prob * (1 - ignore) + ignore
            loss -= _np.sum(_np.log(_np.maximum(1e-10, prob)))
            num += label.size
        self.sum_metric += _np.exp(loss / num) * num
        self.num_inst += num


class MAE(EvalMetric):
    """ref: metric.py:298."""

    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += _np.abs(label - pred).mean()
            self.num_inst += 1


class MSE(EvalMetric):
    """ref: metric.py:316."""

    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


class RMSE(EvalMetric):
    """ref: metric.py:334."""

    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += _np.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    """ref: metric.py:352."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = label.asnumpy()
            pred = pred.asnumpy()
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


class Torch(EvalMetric):
    """Dummy metric for torch criterion outputs (ref: metric.py:301):
    each prediction IS an already-computed loss; accumulate its mean."""

    def __init__(self, name="torch"):
        super().__init__(name)

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += pred.asnumpy().mean()
        self.num_inst += 1


class Caffe(Torch):
    """Dummy metric for caffe criterion outputs (ref: metric.py:311).

    CaffeLoss emits ``[softmax, per_example_nll]`` (the reference
    emitted only the loss blob), so the loss is the LAST head; reading
    preds[-1] reports the loss either way instead of averaging
    probabilities into ~1/num_classes (ADVICE r5)."""

    def __init__(self):
        super().__init__("caffe")

    def update(self, _, preds):
        self.sum_metric += preds[-1].asnumpy().mean()
        self.num_inst += 1


class CustomMetric(EvalMetric):
    """Metric from a feval function (ref: metric.py:379)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = label.asnumpy()
            pred = pred.asnumpy()
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Create a CustomMetric from a numpy function (ref: metric.py:410)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """ref: metric.py:430."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, **kwargs))
        return composite_metric
    metrics = {
        "acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy, "f1": F1,
        "mae": MAE, "mse": MSE, "rmse": RMSE,
        "top_k_accuracy": TopKAccuracy, "perplexity": Perplexity,
    }
    try:
        return metrics[metric.lower()](**kwargs)
    except Exception:
        raise ValueError("Metric must be either callable or in {}".format(
            sorted(metrics.keys())))
