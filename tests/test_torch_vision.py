"""The port's vision ops against the JAX package's, on the CPU.

- ``MultiBoxPrior``: anchors bit-equal, shape inference equal;
- ``MultiBoxTarget``: ``cls_target`` and ``loc_mask`` exactly equal,
  ``loc_target`` within rtol 1e-6, on random images and on crafted ones:
  exact IoU ties (duplicate anchors, duplicate ground truth), exact ties
  in the mining score, an image without ground truth, ``ignore_label``,
  ``minimum_negative_samples``, ``negative_mining_ratio`` -1 and 3; its
  outputs carry no gradient;
- ``MultiBoxDetection``: ids, scores and row order exactly equal, boxes
  within rtol 1e-6, with ``force_suppress`` on and off, score ties,
  another ``background_id``, no suppression and no clipping; the
  gradients of scores and boxes within rtol 1e-4, atol 1e-5;
- ``ROIPooling`` (ReLU'd data: ties in a bin share the gradient),
  ``SpatialTransformer`` and ``Correlation``: forward and the input
  gradients of a random cotangent within rtol 1e-4, atol 1e-5 (f32);
- shape inference and error messages equal to the JAX op's; the
  ``CuDNNBatchNorm`` and ``_CrossDeviceCopy`` names.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu.base import MXNetError as ErrJ
from mxnet_tpu.ops import registry as reg_j
from mxnet_tpu_torch.base import MXNetError as ErrT
from mxnet_tpu_torch.ops import registry as reg_t

RTOL, ATOL = 1e-4, 1e-5
BOX_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_math():
    """torch 2.13's CPU ``exp`` and ``tanh`` can err up to 1.5e-4 relative
    on their first multithreaded call in a process; one call of each on
    a large tensor first avoids it."""
    t = torch.randn(100000)
    torch.exp(t)
    torch.tanh(t)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX references run once each: compile them without XLA's
    optimisation passes, and drop what was compiled when the module
    ends."""
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", prev)
    jax.clear_caches()


def _ops(name, params):
    oj, ot = reg_j.get(name), reg_t.get(name)
    return oj, oj.parse_params(dict(params)), ot, ot.parse_params(dict(params))


def _forward(name, params, inputs):
    """Both packages' outputs (numpy) of one op; the port's tensors too."""
    oj, pj, ot, pt = _ops(name, params)
    outs_j = jax.jit(lambda *xs: oj.apply(pj, list(xs), [], False, None)[0])(
        *[jax.numpy.asarray(x) for x in inputs])
    xs = [torch.tensor(x, requires_grad=x.dtype == np.float32)
          for x in inputs]
    outs_t, _ = ot.apply(pt, xs, [], False, None)
    return [np.asarray(o) for o in outs_j], outs_t


def _pair(name, params, inputs, diff):
    """Both packages' outputs and the gradients of the inputs at ``diff``
    for one random cotangent an output."""
    oj, pj, ot, pt = _ops(name, params)

    def fj(*xs):
        full = list(inputs)
        for k, x in zip(diff, xs):
            full[k] = x
        return oj.apply(pj, [jax.numpy.asarray(v) for v in full], [],
                        False, None)[0]

    outs_j, vjp = jax.vjp(jax.jit(fj),
                          *[jax.numpy.asarray(inputs[k]) for k in diff])
    rng = np.random.RandomState(7)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs_j]
    grads_j = vjp([jax.numpy.asarray(c) for c in cots])
    xs = [torch.tensor(x, requires_grad=k in diff)
          for k, x in enumerate(inputs)]
    outs_t, _ = ot.apply(pt, xs, [], False, None)
    grads_t = torch.autograd.grad(outs_t, [xs[k] for k in diff],
                                  [torch.tensor(c) for c in cots],
                                  allow_unused=True)
    grads_t = [np.zeros_like(inputs[k]) if g is None else g.numpy()
               for k, g in zip(diff, grads_t)]
    return ([np.asarray(o) for o in outs_j], [np.asarray(g) for g in grads_j],
            [o.detach().numpy() for o in outs_t], grads_t)


def _close(res):
    outs_j, grads_j, outs_t, grads_t = res
    assert len(outs_t) == len(outs_j) and len(grads_t) == len(grads_j)
    for a, b in zip(outs_t + grads_t, outs_j + grads_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _same_shapes(name, params, shapes):
    oj, pj, ot, pt = _ops(name, params)
    assert ot.infer_shape(pt, list(shapes)) == oj.infer_shape(pj, list(shapes))


# -- MultiBoxPrior -------------------------------------------------------------
def _anchors(hw=(4, 4), sizes=(0.3, 0.5), ratios=(1, 2, 0.5), clip=True):
    data = np.zeros((1, 1) + tuple(hw), np.float32)
    params = {"sizes": sizes, "ratios": ratios, "clip": clip}
    outs_j, outs_t = _forward("MultiBoxPrior", params, [data])
    np.testing.assert_array_equal(outs_t[0].numpy(), outs_j[0])
    return outs_j[0]


@pytest.mark.parametrize("hw,params", [
    ((4, 4), {}),
    ((8, 8), {"sizes": (0.2, 0.35), "ratios": (1, 2, 0.5), "clip": True}),
    ((3, 5), {"sizes": "(0.1, 0.3, 0.7)", "ratios": "[1, 3, 0.33]"}),
    ((2, 2), {"sizes": 0.9, "ratios": (1, 0.25), "clip": False}),
])
def test_multibox_prior_matches_jax(hw, params):
    data = np.zeros((2, 3) + hw, np.float32)
    outs_j, outs_t = _forward("MultiBoxPrior", params, [data])
    np.testing.assert_array_equal(outs_t[0].numpy(), outs_j[0])
    _same_shapes("MultiBoxPrior", params, [data.shape])


# -- MultiBoxTarget ------------------------------------------------------------
def _boxes(rng, n, lo=0.1, hi=0.6):
    w, h = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
    return np.stack([x1, y1, x1 + w, y1 + h], axis=1).astype(np.float32)


def _labels(rng, B, L, C, counts):
    lab = -np.ones((B, L, 5), np.float32)
    for b, k in enumerate(counts):
        lab[b, :k, 0] = rng.randint(0, C - 1, k)
        lab[b, :k, 1:] = _boxes(rng, k)
    return lab


def _target_case(case):
    """(anchors, labels, cls_preds, params) of a named case."""
    rng = np.random.RandomState(3)
    C = 4
    params = {"overlap_threshold": 0.5, "negative_mining_ratio": 3,
              "negative_mining_thresh": 0.5}
    anchors = _anchors()
    A = anchors.shape[1]
    B, L = 4, 3
    labels = _labels(rng, B, L, C, [1, 3, 2, 0])   # item 3: no ground truth
    cls = rng.randn(B, C, A).astype(np.float32)
    if case == "ratio_-1":
        params["negative_mining_ratio"] = -1
    elif case == "iou_ties":
        # duplicate anchors (sizes repeat) and duplicate ground truth
        anchors = _anchors(sizes=(0.4, 0.4), ratios=(1, 2))
        A = anchors.shape[1]
        labels[1, 1] = labels[1, 0]
        labels[0, 0, 1:] = anchors[0, 5]        # a box equal to an anchor
        labels[2, :2, 1:] = anchors[0, 20]
        cls = rng.randn(B, C, A).astype(np.float32)
    elif case == "mining_ties":
        cls = np.zeros((B, C, A), np.float32)   # every score equal
        cls[:, :, ::7] = 1.0
    elif case == "ignore_label":
        params.update(ignore_label=-2.0, overlap_threshold=0.0)
    elif case == "min_negatives":
        labels[0] = -1                           # a second empty image
        labels[2, :, 1:] = [0.0, 0.0, 0.01, 0.01]  # no anchor overlaps
        params.update(minimum_negative_samples=5,
                      variances=(0.2, 0.1, 0.3, 0.4))
    return anchors, labels, cls, params


@pytest.mark.parametrize("case", ["ratio_3", "ratio_-1", "iou_ties",
                                  "mining_ties", "ignore_label",
                                  "min_negatives"])
def test_multibox_target_matches_jax(case):
    anchors, labels, cls, params = _target_case(case)
    outs_j, outs_t = _forward("MultiBoxTarget", params,
                              [anchors, labels, cls])
    loc_t, mask_t, cls_t = [o.detach().numpy() for o in outs_t]
    loc_j, mask_j, cls_j = outs_j
    np.testing.assert_array_equal(cls_t, cls_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    np.testing.assert_allclose(loc_t, loc_j, rtol=BOX_RTOL, atol=1e-6)
    assert not any(o.requires_grad for o in outs_t)
    # the crafted cases reach what they were made for
    assert (cls_j[3] == params.get("ignore_label", -1.0)).all()
    assert (cls_j > 0).any()
    if case != "ratio_-1":
        assert (cls_j == 0).any()


@pytest.mark.parametrize("shapes,msg", [
    ([(1, 10, 4), (2, 3, 5), None], "input shapes unknown"),
    ([(2, 10, 4), (2, 3, 5), (2, 4, 10)], "anchor must be"),
    ([(1, 10, 4), (2, 3, 4), (2, 4, 10)], "label must be"),
    ([(1, 10, 4), (2, 3, 5), (2, 4, 9)], "cls_pred must be"),
])
def test_multibox_target_shape_errors_match_jax(shapes, msg):
    oj, pj, ot, pt = _ops("MultiBoxTarget", {})
    with pytest.raises(ErrJ) as ej:
        oj.infer_shape(pj, shapes)
    with pytest.raises(ErrT) as et:
        ot.infer_shape(pt, shapes)
    assert str(et.value) == str(ej.value) and msg in str(et.value)


def test_multibox_target_shapes_match_jax():
    _same_shapes("MultiBoxTarget", {}, [(1, 64, 4), (4, 3, 5), (4, 4, 64)])


# -- MultiBoxDetection ---------------------------------------------------------
def _detection_inputs(seed=5, B=3, C=4, ties=False):
    rng = np.random.RandomState(seed)
    anchors = _anchors((4, 4), sizes=(0.3, 0.6), ratios=(1, 2, 0.5))
    A = anchors.shape[1]
    logits = rng.randn(B, C, A).astype(np.float32) * 2
    if ties:
        logits[:, :, ::3] = 0.0          # equal scores in many anchors
        logits[1, :, 5] = [0.0, 3.0, 3.0, -1.0]   # a tie between classes
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    prob = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(B, A * 4) * 0.5).astype(np.float32)
    return prob, loc, anchors


@pytest.mark.parametrize("params,ties", [
    ({"force_suppress": False}, False),
    ({"force_suppress": True}, False),
    ({"force_suppress": False, "threshold": 0.3}, True),
    ({"force_suppress": True, "nms_threshold": 0.3}, True),
    ({"background_id": 1, "nms_threshold": 0.45}, False),
    ({"nms_threshold": 0.0, "clip": False}, False),
])
def test_multibox_detection_matches_jax(params, ties):
    prob, loc, anchors = _detection_inputs(ties=ties)
    outs_j, grads_j, outs_t, grads_t = _pair(
        "MultiBoxDetection", dict(params, variances=(0.1, 0.1, 0.2, 0.2)),
        [prob, loc, anchors], diff=[0, 1])
    got, want = outs_t[0], outs_j[0]
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=BOX_RTOL,
                               atol=1e-7)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    kept = want[..., 0] >= 0
    assert kept.any() and (~kept).any()


def test_multibox_detection_shapes_and_errors_match_jax():
    _same_shapes("MultiBoxDetection", {}, [(2, 4, 64), (2, 256), (1, 64, 4)])
    oj, pj, ot, pt = _ops("MultiBoxDetection", {})
    for shapes in ([(2, 4, 64), (2, 255), (1, 64, 4)],
                   [(2, 4, 64), (2, 256, 1), (1, 64, 4)],
                   [(2, 4, 64), None, (1, 64, 4)]):
        with pytest.raises(ErrJ) as ej:
            oj.infer_shape(pj, shapes)
        with pytest.raises(ErrT) as et:
            ot.infer_shape(pt, shapes)
        assert str(et.value) == str(ej.value)


# -- ROIPooling ----------------------------------------------------------------
ROIS = np.array([
    [0, 0, 0, 15, 15],        # the whole image
    [1, 2.5, 3.5, 9.5, 7.5],  # halves round to even
    [1, 10, 4, 11, 5],        # smaller than the output: empty-free bins
    [0, -4, -4, 3, 3],        # partly outside
    [-1, 6, 6, 30, 30],       # batch -1 wraps to the last image
    [5, 1, 1, 2, 2],          # batch 5 clamps to the last image
], np.float32)


@pytest.mark.parametrize("pooled,scale", [((2, 2), 1.0), ((3, 2), 0.5)])
def test_roi_pooling_matches_jax(pooled, scale):
    rng = np.random.RandomState(11)
    data = np.maximum(rng.randn(2, 3, 16, 16), 0).astype(np.float32)
    params = {"pooled_size": pooled, "spatial_scale": scale}
    _close(_pair("ROIPooling", params, [data, ROIS], diff=[0]))
    _same_shapes("ROIPooling", params, [data.shape, ROIS.shape])


# -- SpatialTransformer --------------------------------------------------------
def test_spatial_transformer_matches_jax():
    rng = np.random.RandomState(12)
    data = rng.randn(3, 2, 9, 11).astype(np.float32)
    ident = np.array([1, 0, 0, 0, 1, 0], np.float32)
    loc = (ident + rng.randn(3, 6) * 0.3).astype(np.float32)
    loc[2, 2] = 0.8   # shifted past the border
    params = {"target_shape": (7, 6)}
    _close(_pair("SpatialTransformer", params, [data, loc], diff=[0, 1]))
    _same_shapes("SpatialTransformer", params, [data.shape, None])


# -- Correlation ---------------------------------------------------------------
@pytest.mark.parametrize("params", [
    {"kernel_size": 1, "max_displacement": 2, "stride2": 1,
     "is_multiply": True},
    {"kernel_size": 3, "max_displacement": 2, "stride1": 2, "stride2": 2,
     "pad_size": 2, "is_multiply": True},
    {"kernel_size": 3, "max_displacement": 1, "pad_size": 1,
     "is_multiply": False},
])
def test_correlation_matches_jax(params):
    rng = np.random.RandomState(13)
    a = rng.randn(2, 3, 8, 9).astype(np.float32)
    b = rng.randn(2, 3, 8, 9).astype(np.float32)
    _close(_pair("Correlation", params, [a, b], diff=[0, 1]))
    _same_shapes("Correlation", params, [a.shape, None])


@pytest.mark.parametrize("params,shape", [
    ({"kernel_size": 2}, (1, 1, 8, 8)),
    ({"kernel_size": 3, "max_displacement": 4}, (1, 1, 8, 8)),
    ({}, (1, 8, 8)),
    ({}, None),
])
def test_correlation_errors_match_jax(params, shape):
    oj, pj, ot, pt = _ops("Correlation", params)
    with pytest.raises(ErrJ) as ej:
        oj.infer_shape(pj, [shape, shape])
    with pytest.raises(ErrT) as et:
        ot.infer_shape(pt, [shape, shape])
    assert str(et.value) == str(ej.value)


# -- aliases -------------------------------------------------------------------
def test_aliases_match_jax():
    assert reg_t.REGISTRY["CuDNNBatchNorm"] is reg_t.REGISTRY["BatchNorm"]
    assert reg_j.REGISTRY["CuDNNBatchNorm"] is reg_j.REGISTRY["BatchNorm"]
    op = reg_t.get("_CrossDeviceCopy")
    assert not op.imperative and not reg_j.get("_CrossDeviceCopy").imperative
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    _close(_pair("_CrossDeviceCopy", {}, [x], diff=[0]))
