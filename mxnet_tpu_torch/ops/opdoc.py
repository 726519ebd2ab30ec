"""Operator documentation: summaries, per-parameter docs, and the
docstring renderer.

The reference auto-generates full param-documented docstrings into every
``mx.symbol.*`` / ``mx.nd.*`` function at import time from the C
registry's dmlc::Parameter schemas (ref: python/mxnet/symbol.py:991
``_make_atomic_symbol_function``, python/mxnet/ndarray.py:1283). Here the
schema already lives in :class:`~mxnet_tpu.ops.registry.Field`; this
module adds the prose (kept out of the op-definition files so the
kernels stay readable) and renders numpy-style docstrings from
schema + prose. ``apply_to(op)`` runs inside ``registry.register()`` so
late registrations (Custom, plugin ops) are covered;
``build_doc(op, name, kind)`` is used by ``ops.install`` /
``symbol._make_op_func`` and by ``tools/gen_api_docs.py``.
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# Prose tables. OPDOC: op name -> (summary, {param name -> doc}).
# Input-argument docs: per-op overrides in ARGDOC, generic fallbacks in
# _GENERIC_ARGS. Aliases share the OpDef object, so docs follow for free.
# ---------------------------------------------------------------------------

_GENERIC_ARGS = {
    "data": "Input tensor.",
    "lhs": "First input tensor.",
    "rhs": "Second input tensor.",
    "weight": "Weight parameter.",
    "bias": "Bias parameter (omitted when ``no_bias`` is true).",
    "label": "Target values.",
    "gamma": "Per-channel scale parameter.",
    "beta": "Per-channel shift parameter.",
    "mask": "Mask tensor; zero entries select 0 in the output.",
}

ARGDOC = {
    "Convolution": {
        "data": "Input feature map, layout (batch, channel, height, width).",
        "weight": "Filter bank, layout (num_filter, channel/num_group, kh, kw).",
    },
    "Deconvolution": {
        "data": "Input feature map, layout (batch, channel, height, width).",
        "weight": "Filter bank shared with the matching Convolution layout.",
    },
    "Embedding": {
        "data": "Integer indices into the embedding table, any shape.",
        "weight": "Embedding table of shape (input_dim, output_dim).",
    },
    "RNN": {
        "data": "Sequence input, layout (seq_len, batch, feature).",
        "parameters": "All layer weights packed into one flat vector.",
        "state": "Initial hidden state (and cell state for LSTM).",
    },
    "ROIPooling": {
        "data": "Feature map, layout (batch, channel, height, width).",
        "rois": "Regions of interest, shape (n, 5): (batch_index, x1, y1, x2, y2) "
                "in image coordinates.",
    },
    "SpatialTransformer": {
        "data": "Input feature map to sample from.",
        "loc": "Output of the localisation network: 6 affine parameters per sample.",
    },
    "Correlation": {
        "data1": "First feature map (batch, channel, height, width).",
        "data2": "Second feature map, same shape as data1.",
    },
    "MultiBoxPrior": {
        "data": "Feature map whose spatial grid anchors are generated over.",
    },
    "MultiBoxTarget": {
        "anchor": "Anchor boxes, shape (1, num_anchors, 4), corner format.",
        "label": "Ground-truth boxes, shape (batch, num_labels, 5): (cls, x1, y1, x2, y2).",
        "cls_pred": "Class predictions used for online negative mining.",
    },
    "MultiBoxDetection": {
        "cls_prob": "Class probabilities, shape (batch, num_classes, num_anchors).",
        "loc_pred": "Box regression predictions, shape (batch, num_anchors*4).",
        "anchor": "Anchor boxes, shape (1, num_anchors, 4).",
    },
    "SequenceLast": {
        "data": "Time-major sequence input (seq_len, batch, ...); an optional "
                "second input gives per-example valid lengths.",
    },
    "SequenceMask": {
        "data": "Time-major sequence input (seq_len, batch, ...); an optional "
                "second input gives per-example valid lengths.",
    },
    "SequenceReverse": {
        "data": "Time-major sequence input (seq_len, batch, ...); an optional "
                "second input gives per-example valid lengths.",
    },
    "element_mask": {
        "data": "Input tensor.",
        "mask": "Per-row mask vector broadcast over trailing axes.",
    },
    "fill_element_0index": {
        "lhs": "Tensor whose rows are updated.",
        "mhs": "Values to write, one per row.",
        "rhs": "Column index per row (float, truncated to int).",
    },
    "choose_element_0index": {
        "lhs": "Tensor to pick from, shape (n, k).",
        "rhs": "Column index per row.",
    },
    "softmax_cross_entropy": {
        "data": "Unnormalised logits, shape (n, k).",
        "label": "Integer class ids, shape (n,).",
    },
    "WarpCTC": {
        "data": "Unnormalised activations, layout (seq_len*batch, alphabet).",
        "label": "Padded label ids, shape (batch, max_label_len).",
    },
    "TorchCriterion": {
        "data": "Prediction input handed to the torch criterion.",
        "label": "Target input handed to the torch criterion.",
    },
    "TorchModule": {
        "data": "Data inputs (num_data of them), then parameter inputs.",
    },
}

OPDOC = {
    # -- neural-network layers -------------------------------------------------
    "Activation": (
        "Apply an elementwise nonlinearity to the input.",
        {"act_type": "Nonlinearity to apply."},
    ),
    "LeakyReLU": (
        "Leaky/parametric rectifier family: variants of ReLU that keep a "
        "small slope for negative inputs.",
        {
            "act_type": "Which variant: fixed slope (leaky), exponential "
                        "(elu), learned per-channel slope (prelu), or "
                        "randomised slope during training (rrelu).",
            "slope": "Negative-region slope for leaky/elu.",
            "lower_bound": "Lower bound of the rrelu training slope.",
            "upper_bound": "Upper bound of the rrelu training slope.",
        },
    ),
    "FullyConnected": (
        "Dense layer: flatten trailing axes, multiply by a weight matrix "
        "and add a bias.",
        {
            "num_hidden": "Number of output features.",
            "no_bias": "Skip the bias term.",
        },
    ),
    "Convolution": (
        "N-D convolution (2-D or 3-D) with optional grouping, strides, "
        "dilation and zero padding; lowers to an MXU-tiled "
        "lax.conv_general_dilated.",
        {
            "kernel": "Spatial extent of the filter, e.g. (3, 3).",
            "stride": "Step between filter applications; defaults to ones.",
            "dilate": "Spacing between filter taps; defaults to ones.",
            "pad": "Implicit zero padding per spatial side; defaults to zeros.",
            "num_filter": "Number of output channels.",
            "num_group": "Split input channels into this many groups "
                         "convolved independently.",
            "workspace": "Accepted for API compatibility; XLA plans scratch "
                         "memory itself.",
            "cudnn_tune": "Accepted and ignored on TPU.",
            "cudnn_off": "Accepted and ignored on TPU.",
            "no_bias": "Skip the bias term.",
        },
    ),
    "Deconvolution": (
        "Transposed convolution (gradient of Convolution with respect to "
        "its input), used for learned upsampling.",
        {
            "kernel": "Spatial extent of the filter.",
            "stride": "Upsampling factor per spatial axis.",
            "dilate": "Spacing between filter taps.",
            "pad": "Padding that the matching forward convolution would use.",
            "adj": "Extra output rows/cols on the bottom/right edge "
                   "(must be < stride); ignored when target_shape is set.",
            "target_shape": "Exact output spatial size; pad and adj are "
                            "deduced automatically.",
            "num_filter": "Number of output channels.",
            "num_group": "Channel groups processed independently.",
            "workspace": "Accepted for API compatibility; ignored.",
            "cudnn_tune": "Accepted and ignored on TPU.",
            "cudnn_off": "Accepted and ignored on TPU.",
            "no_bias": "Skip the bias term.",
        },
    ),
    "Pooling": (
        "Spatial pooling (max, average or sum) over sliding windows.",
        {
            "kernel": "Pooling window size.",
            "pool_type": "Reduction applied inside each window.",
            "global_pool": "Pool over the entire spatial extent, ignoring "
                           "kernel/stride/pad.",
            "pooling_convention": "Output-size rounding: 'valid' floors "
                                  "(discarding ragged edges), 'full' ceils "
                                  "(windows may hang over the padded edge).",
            "stride": "Step between windows; defaults to ones.",
            "pad": "Implicit zero padding per spatial side.",
        },
    ),
    "BatchNorm": (
        "Batch normalisation: standardise over the batch and spatial axes, "
        "then scale and shift per channel. Running mean/var are kept as "
        "auxiliary states updated during training.",
        {
            "eps": "Added to the variance for numerical stability.",
            "momentum": "Exponential decay rate of the running statistics.",
            "fix_gamma": "Freeze gamma at 1 (only beta trains).",
            "use_global_stats": "Normalise with the running statistics even "
                                "during training (inference-style).",
        },
    ),
    "InstanceNorm": (
        "Instance normalisation: standardise each sample over its spatial "
        "axes independently, then scale and shift per channel.",
        {"eps": "Added to the variance for numerical stability."},
    ),
    "L2Normalization": (
        "Scale the input to unit L2 norm over the chosen extent.",
        {
            "eps": "Added to the norm for numerical stability.",
            "mode": "Extent of the norm: whole sample (instance), per "
                    "spatial position across channels (channel), or per "
                    "channel across positions (spatial).",
        },
    ),
    "LRN": (
        "Local response normalisation across neighbouring channels "
        "(AlexNet-style).",
        {
            "alpha": "Scale applied to the squared-activation sum.",
            "beta": "Exponent of the normalisation denominator.",
            "knorm": "Additive constant in the denominator.",
            "nsize": "Number of neighbouring channels summed over.",
        },
    ),
    "Dropout": (
        "Randomly zero activations during training and rescale the "
        "survivors by 1/(1-p); identity at inference.",
        {"p": "Probability of zeroing each activation."},
    ),
    "Embedding": (
        "Look up integer indices in a learned table, mapping each id to a "
        "dense vector.",
        {
            "input_dim": "Vocabulary size (number of rows in the table).",
            "output_dim": "Embedding vector length.",
        },
    ),
    "RNN": (
        "Fused multi-layer recurrent network (RNN/LSTM/GRU variants) over a "
        "full sequence, implemented as a compiled lax.scan. The reference's "
        "op is cuDNN-only with a fatal CPU path (ref: src/operator/rnn.cc:13); "
        "this one runs everywhere.",
        {
            "state_size": "Hidden state width.",
            "num_layers": "Number of stacked recurrent layers.",
            "mode": "Cell type: rnn_relu, rnn_tanh, lstm or gru.",
            "bidirectional": "Run a second stack over the reversed sequence "
                             "and concatenate features.",
            "p": "Dropout probability between layers during training.",
            "state_outputs": "Also return the final hidden (and cell) state.",
            "pkeep_": "Accepted for API compatibility; ignored.",
        },
    ),
    "SoftmaxActivation": (
        "Softmax as a plain activation (no loss attached).",
        {"mode": "Normalise over the last axis per sample (instance) or "
                 "across channels at each spatial position (channel)."},
    ),
    "SwapAxis": (
        "Exchange two axes of the input.",
        {"dim1": "First axis.", "dim2": "Second axis."},
    ),
    "Reshape": (
        "Reinterpret the input with a new shape of equal size; supports "
        "0 (copy input dim), -1 (infer) and the legacy target_shape form.",
        {
            "shape": "Target dimensions, with 0 copying the input dimension "
                     "and -1 inferred from the remaining size.",
            "target_shape": "Legacy alternative to shape: (0, d1, d2, ...) "
                            "keeps the batch axis.",
            "keep_highest": "With target_shape: always preserve the leading "
                            "axis unchanged.",
            "reverse": "Match shape entries against the input from the "
                       "trailing axis backwards.",
        },
    ),
    "Flatten": (
        "Collapse all axes after the first into one, giving (batch, -1).",
        {},
    ),
    "Concat": (
        "Join multiple inputs along an existing axis; all other axes must "
        "agree.",
        {
            "num_args": "Number of inputs being concatenated.",
            "dim": "Axis to join along.",
        },
    ),
    "SliceChannel": (
        "Split the input into equal parts along an axis (inverse of "
        "Concat); with squeeze_axis the split axis of size 1 is dropped.",
        {
            "num_outputs": "Number of equal slices to produce.",
            "axis": "Axis to split along.",
            "squeeze_axis": "Remove the split axis when each slice has "
                            "size 1 there.",
        },
    ),
    "ElementWiseSum": (
        "Sum any number of same-shaped inputs elementwise.",
        {"num_args": "Number of inputs summed."},
    ),
    "Crop": (
        "Crop the spatial axes of the first input, either to a reference "
        "input's size (2-arg form) or to an explicit h_w, at a given or "
        "centred offset.",
        {
            "num_args": "1 (explicit h_w) or 2 (crop like the second input).",
            "offset": "Top-left corner (y, x) of the crop window.",
            "h_w": "Output height and width for the 1-arg form.",
            "center_crop": "Centre the window instead of using offset.",
        },
    ),
    "Pad": (
        "Pad the spatial axes with a constant or edge replication.",
        {
            "mode": "Padding fill rule.",
            "pad_width": "Per-axis (before, after) pad amounts, 2 entries "
                         "per axis in NCHW order; batch/channel must be 0.",
            "constant_value": "Fill value for constant mode.",
        },
    ),
    "Cast": (
        "Convert the input to another dtype.",
        {"dtype": "Destination dtype name, e.g. float32, float16, uint8."},
    ),
    "BlockGrad": (
        "Identity in the forward pass; stops gradient flow in the backward "
        "pass.",
        {},
    ),
    "IdentityAttachKLSparseReg": (
        "Identity that attaches a KL-divergence sparsity penalty on the "
        "mean activation to the gradient (sparse-autoencoder "
        "regulariser); tracks the moving mean as an auxiliary state.",
        {
            "sparseness_target": "Desired mean activation rho.",
            "penalty": "Weight of the regulariser gradient.",
            "momentum": "Decay of the moving average of the mean activation.",
        },
    ),
    "Custom": (
        "Run a user-registered Python operator (CustomOp) inside the "
        "graph; executed eagerly on the host between compiled segments.",
        {
            "op_type": "Name the operator was registered under.",
            "__kwargs__": "String kwargs forwarded to the user Prop "
                          "constructor.",
        },
    ),
    "_CrossDeviceCopy": (
        "Explicit device-to-device transfer inserted at ctx_group "
        "boundaries by the executor.",
        {},
    ),
    "UpSampling": (
        "Spatially enlarge feature maps by an integer factor, by nearest "
        "repetition or a learned/fixed bilinear kernel.",
        {
            "scale": "Integer enlargement factor.",
            "num_filter": "Channel count for the bilinear filter form.",
            "sample_type": "nearest repetition or bilinear interpolation "
                           "(via Deconvolution).",
            "multi_input_mode": "With several inputs: concat them after "
                                "scaling, or sum them.",
            "num_args": "Number of inputs.",
            "workspace": "Accepted for API compatibility; ignored.",
        },
    ),
    "SpatialTransformer": (
        "Differentiable image warp: apply a per-sample affine transform "
        "predicted by a localisation network, sampling with bilinear "
        "interpolation.",
        {
            "target_shape": "Output spatial size (h, w).",
            "transform_type": "Transform family; affine is supported.",
            "sampler_type": "Interpolation used when sampling; bilinear.",
        },
    ),
    "Correlation": (
        "Correlate patches between two feature maps across spatial "
        "displacements (FlowNet-style cost volume).",
        {
            "kernel_size": "Patch size correlated at each position.",
            "max_displacement": "Largest displacement searched in each "
                                "direction.",
            "stride1": "Stride over positions in the first map.",
            "stride2": "Stride over displacements in the second map.",
            "pad_size": "Zero padding applied to both maps.",
            "is_multiply": "Correlate by product (true) or absolute "
                           "difference (false).",
        },
    ),
    "ROIPooling": (
        "Max-pool each region of interest onto a fixed spatial grid "
        "(Fast R-CNN pooling).",
        {
            "pooled_size": "Output grid (h, w) per region.",
            "spatial_scale": "Multiplier mapping image coordinates to "
                             "feature-map coordinates (1/total stride).",
        },
    ),
    # -- loss / output layers --------------------------------------------------
    "SoftmaxOutput": (
        "Softmax over the last (or channel) axis with cross-entropy "
        "gradient against the label — the standard classification head. "
        "SoftmaxOutput is the canonical name; Softmax is the legacy alias.",
        {
            "grad_scale": "Multiplier on the backward gradient.",
            "ignore_label": "With use_ignore: label value whose samples "
                            "contribute no gradient.",
            "multi_output": "Treat axis 1 as classes and softmax at every "
                            "trailing position (fully-convolutional heads).",
            "use_ignore": "Enable ignore_label masking.",
            "preserve_shape": "Softmax over the last axis keeping the "
                              "input shape.",
            "normalization": "Gradient normalisation: none (null), by batch "
                             "size (batch), or by non-ignored samples "
                             "(valid).",
            "out_grad": "Also multiply by an incoming head gradient rather "
                        "than acting as a terminal loss.",
        },
    ),
    "LinearRegressionOutput": (
        "Identity output whose gradient is the L2 regression residual "
        "(prediction minus label).",
        {"grad_scale": "Multiplier on the backward gradient."},
    ),
    "MAERegressionOutput": (
        "Identity output whose gradient is the sign of the residual "
        "(L1 regression).",
        {"grad_scale": "Multiplier on the backward gradient."},
    ),
    "LogisticRegressionOutput": (
        "Sigmoid output whose gradient is prediction minus label "
        "(binary cross-entropy shortcut).",
        {"grad_scale": "Multiplier on the backward gradient."},
    ),
    "SVMOutput": (
        "Hinge-loss output layer for margin classification, linear or "
        "squared hinge.",
        {
            "margin": "Required score margin between true and rival "
                      "classes.",
            "regularization_coefficient": "Scale on the loss gradient.",
            "use_linear": "Linear (L1) hinge instead of squared hinge.",
        },
    ),
    "MakeLoss": (
        "Turn any scalar-per-sample expression into a training loss: "
        "forward passes the value through, backward seeds ones (times "
        "grad_scale).",
        {
            "grad_scale": "Multiplier on the backward gradient.",
            "valid_thresh": "With normalization='valid': entries above this "
                            "threshold count as valid.",
            "normalization": "Divide the gradient by nothing (null), batch "
                             "size (batch), or the valid-entry count "
                             "(valid).",
        },
    ),
    "WarpCTC": (
        "Connectionist temporal classification loss over unsegmented "
        "sequences, with the standard forward-backward recursion computed "
        "in log space.",
        {
            "label_length": "Padded length of each label row (0 = use the "
                            "whole row).",
            "input_length": "Time steps per example.",
        },
    ),
    "softmax_cross_entropy": (
        "Fused softmax + cross-entropy scalar loss over a batch of logits.",
        {},
    ),
    "TorchModule": (
        "Run a torch.nn.Module as an operator via the torch plugin bridge "
        "(ref: plugin/torch/torch_module-inl.h); executes on the host "
        "between compiled segments.",
        {
            "module_string": "Python expression building the torch module.",
            "lua_string": "Accepted for reference compatibility.",
            "num_data": "Number of data inputs.",
            "num_params": "Number of parameter inputs following the data.",
            "num_outputs": "Number of outputs the module returns.",
        },
    ),
    "TorchCriterion": (
        "Run a torch criterion (loss) as an operator via the torch plugin "
        "bridge (ref: plugin/torch/torch_criterion-inl.h).",
        {
            "module_string": "Python expression building the torch "
                             "criterion.",
            "lua_string": "Accepted for reference compatibility.",
            "grad_scale": "Multiplier on the backward gradient.",
        },
    ),
    # -- detection (SSD) -------------------------------------------------------
    "MultiBoxPrior": (
        "Generate SSD anchor boxes over the feature-map grid for given "
        "sizes and aspect ratios.",
        {
            "sizes": "Anchor scales relative to the image.",
            "ratios": "Anchor width/height aspect ratios.",
            "clip": "Clip anchors to the [0, 1] image frame.",
        },
    ),
    "MultiBoxTarget": (
        "Match anchors to ground-truth boxes and emit classification "
        "targets, localisation targets and masks, with optional online "
        "hard negative mining.",
        {
            "overlap_threshold": "Minimum IoU for an anchor to take a "
                                 "ground-truth match.",
            "ignore_label": "Class target for anchors excluded from the "
                            "classification loss.",
            "negative_mining_ratio": "Max negatives kept per positive "
                                     "(-1 disables mining).",
            "negative_mining_thresh": "Min background confidence for a "
                                      "negative to be minable.",
            "minimum_negative_samples": "Lower bound on kept negatives.",
            "variances": "Box-encoding variances dividing the regression "
                         "targets.",
        },
    ),
    "MultiBoxDetection": (
        "Decode box regressions against anchors and run per-class "
        "non-maximum suppression, producing (class, score, box) rows.",
        {
            "clip": "Clip decoded boxes to the image frame.",
            "threshold": "Discard detections scoring below this.",
            "background_id": "Class id treated as background.",
            "nms_threshold": "IoU above which the lower-scoring box is "
                             "suppressed.",
            "force_suppress": "Suppress across classes, not just within "
                              "one.",
            "variances": "Box-encoding variances multiplying the "
                         "predictions during decoding.",
        },
    ),
    # -- sequence ops ----------------------------------------------------------
    "SequenceLast": (
        "Select the last valid time step of each sequence.",
        {"use_sequence_length": "Read per-example lengths from a second "
                                "input instead of assuming full length."},
    ),
    "SequenceMask": (
        "Overwrite time steps beyond each sequence's valid length with a "
        "constant.",
        {
            "use_sequence_length": "Read per-example lengths from a second "
                                   "input.",
            "value": "Fill value for masked steps.",
        },
    ),
    "SequenceReverse": (
        "Reverse each sequence along time, respecting per-example valid "
        "lengths.",
        {"use_sequence_length": "Read per-example lengths from a second "
                                "input."},
    ),
    # -- tensor / simple ops ---------------------------------------------------
    "_plus": ("Elementwise sum of two tensors.", {}),
    "_minus": ("Elementwise difference of two tensors.", {}),
    "_mul": ("Elementwise product of two tensors.", {}),
    "_div": ("Elementwise quotient of two tensors.", {}),
    "_power": ("Elementwise lhs raised to the rhs power.", {}),
    "_maximum": ("Elementwise maximum of two tensors.", {}),
    "_minimum": ("Elementwise minimum of two tensors.", {}),
    "negative": ("Elementwise negation.", {}),
    "_plus_scalar": ("Add a scalar to every element.",
                     {"scalar": "Scalar operand."}),
    "_minus_scalar": ("Subtract a scalar from every element.",
                      {"scalar": "Scalar operand."}),
    "_rminus_scalar": ("Scalar minus tensor, elementwise.",
                       {"scalar": "Scalar operand."}),
    "_mul_scalar": ("Multiply every element by a scalar.",
                    {"scalar": "Scalar operand."}),
    "_div_scalar": ("Divide every element by a scalar.",
                    {"scalar": "Scalar operand."}),
    "_rdiv_scalar": ("Scalar divided by tensor, elementwise.",
                     {"scalar": "Scalar operand."}),
    "_power_scalar": ("Raise every element to a scalar power.",
                      {"scalar": "Scalar operand."}),
    "_rpower_scalar": ("Scalar raised to each element, elementwise.",
                       {"scalar": "Scalar operand."}),
    "_maximum_scalar": ("Elementwise maximum against a scalar.",
                        {"scalar": "Scalar operand."}),
    "_minimum_scalar": ("Elementwise minimum against a scalar.",
                        {"scalar": "Scalar operand."}),
    "abs": ("Elementwise absolute value.", {}),
    "ceil": ("Elementwise ceiling.", {}),
    "floor": ("Elementwise floor.", {}),
    "round": ("Elementwise rounding to the nearest integer.", {}),
    "sign": ("Elementwise sign (-1, 0 or 1).", {}),
    "exp": ("Elementwise natural exponential.", {}),
    "log": ("Elementwise natural logarithm.", {}),
    "sqrt": ("Elementwise square root.", {}),
    "rsqrt": ("Elementwise reciprocal square root.", {}),
    "square": ("Elementwise square.", {}),
    "cos": ("Elementwise cosine.", {}),
    "sin": ("Elementwise sine.", {}),
    "tanh_op": ("Elementwise hyperbolic tangent.", {}),
    "clip": (
        "Limit every element to the closed range [a_min, a_max].",
        {"a_min": "Lower clip bound.", "a_max": "Upper clip bound."},
    ),
    "smooth_l1": (
        "Smooth L1 (Huber-style) value: quadratic near zero, linear "
        "beyond 1/sigma^2.",
        {"scalar": "Transition sharpness sigma."},
    ),
    "sum": (
        "Sum over the given axes (all axes by default).",
        {
            "axis": "Axes to reduce; empty means all.",
            "keepdims": "Keep reduced axes as size-1 dimensions.",
        },
    ),
    "max": (
        "Maximum over the given axes (all axes by default).",
        {
            "axis": "Axes to reduce; empty means all.",
            "keepdims": "Keep reduced axes as size-1 dimensions.",
        },
    ),
    "min": (
        "Minimum over the given axes (all axes by default).",
        {
            "axis": "Axes to reduce; empty means all.",
            "keepdims": "Keep reduced axes as size-1 dimensions.",
        },
    ),
    "mean": (
        "Mean over the given axes (all axes by default).",
        {
            "axis": "Axes to reduce; empty means all.",
            "keepdims": "Keep reduced axes as size-1 dimensions.",
        },
    ),
    "norm": ("Frobenius (L2) norm of the whole tensor, as a scalar.", {}),
    "argmax": (
        "Index of the maximum along an axis (flattened when axis is "
        "unset).",
        {"axis": "Axis to search along."},
    ),
    "argmin": (
        "Index of the minimum along an axis (flattened when axis is "
        "unset).",
        {"axis": "Axis to search along."},
    ),
    "argmax_channel": (
        "Per-row argmax over the last axis — the prediction extractor for "
        "classification outputs.",
        {},
    ),
    "dot": (
        "Matrix product of two 2-D tensors (or inner product of vectors), "
        "with optional transposes; maps directly onto the MXU.",
        {
            "transpose_a": "Transpose the first operand.",
            "transpose_b": "Transpose the second operand.",
        },
    ),
    "batch_dot": (
        "Batched matrix product over matching leading batch axes.",
        {
            "transpose_a": "Transpose each first operand.",
            "transpose_b": "Transpose each second operand.",
        },
    ),
    "transpose": (
        "Permute axes (reverse them when axes is empty).",
        {"axes": "New axis order."},
    ),
    "expand_dims": (
        "Insert a size-1 axis at the given position.",
        {"axis": "Position of the new axis."},
    ),
    "flip": (
        "Reverse the input along one axis.",
        {"axis": "Axis to reverse."},
    ),
    "crop_nd": (
        "Slice a hyper-rectangle [begin, end) from the input.",
        {"begin": "Inclusive start per axis.", "end": "Exclusive end per axis."},
    ),
    "slice_axis": (
        "Slice [begin, end) along one axis.",
        {
            "axis": "Axis to slice.",
            "begin": "Inclusive start (negative counts from the end).",
            "end": "Exclusive end; unset means to the end.",
        },
    ),
    "broadcast_axis": (
        "Repeat size-1 axes to the requested sizes.",
        {
            "axis": "Axes to broadcast (must have size 1).",
            "size": "Target size per listed axis.",
        },
    ),
    "broadcast_to": (
        "Broadcast the input to a full target shape (0 keeps the input "
        "size on that axis).",
        {"shape": "Target shape."},
    ),
    "broadcast_plus": ("Elementwise sum with numpy-style broadcasting.", {}),
    "broadcast_minus": ("Elementwise difference with numpy-style "
                        "broadcasting.", {}),
    "broadcast_mul": ("Elementwise product with numpy-style broadcasting.", {}),
    "broadcast_div": ("Elementwise quotient with numpy-style broadcasting.", {}),
    "broadcast_power": ("Elementwise power with numpy-style broadcasting.", {}),
    "broadcast_equal": ("Elementwise equality (0/1) with numpy-style "
                        "broadcasting.", {}),
    "broadcast_greater": ("Elementwise greater-than (0/1) with numpy-style "
                          "broadcasting.", {}),
    "broadcast_lesser": ("Elementwise less-than (0/1) with numpy-style "
                         "broadcasting.", {}),
    "broadcast_maximum": ("Elementwise maximum with numpy-style "
                          "broadcasting.", {}),
    "broadcast_minimum": ("Elementwise minimum with numpy-style "
                          "broadcasting.", {}),
    "element_mask": (
        "Zero out rows of the input where the mask is zero.",
        {},
    ),
    "choose_element_0index": (
        "Pick one element per row by column index (batched gather).",
        {},
    ),
    "fill_element_0index": (
        "Write one value per row at a column index (batched scatter), "
        "returning the updated tensor.",
        {},
    ),
}


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------

_TYPE_NAMES = {
    "int": "int",
    "float": "float",
    "bool": "boolean",
    "shape": "Shape(tuple)",
    "str": "string",
    "any": "object",
}


def _field_header(name, f):
    t = _TYPE_NAMES.get(f.type, f.type)
    if f.enum:
        t = "{%s}" % ", ".join(repr(e) for e in f.enum)
    tail = ", required" if f.required else (
        ", optional, default=%r" % (f.default,))
    return "%s : %s%s" % (name, t, tail)


def _wrap(text, indent="    ", width=72):
    import textwrap

    return textwrap.fill(text, width=width, initial_indent=indent,
                         subsequent_indent=indent)


def build_doc(op, func_name, kind):
    """Render a numpy-style docstring for an op wrapper.

    kind: 'symbol' or 'ndarray' — controls the input/return type names.
    Mirrors what the reference's _make_atomic_symbol_function composes
    from the C registry (ref: python/mxnet/symbol.py:991)."""
    typ = "Symbol" if kind == "symbol" else "NDArray"
    summary, pdocs = OPDOC.get(op.name, (None, {}))
    summary = summary or op.doc or ("Operator %s." % op.name)
    argdocs = ARGDOC.get(op.name, {})
    try:
        args = op.list_arguments({})
    except Exception:
        args = ["data"]
    try:
        outs = op.list_outputs({})
    except Exception:
        outs = ["output"]
    try:
        aux = op.list_auxiliary_states({})
    except Exception:
        aux = []

    lines = [summary, "", "Parameters", "----------"]
    if op.key_var_num_args:
        # variadic ops take *args, not the placeholder argument names
        lines.append("*args : positional %ss" % typ)
        lines.append(_wrap("Variadic inputs; their count sets %s."
                           % op.key_var_num_args))
    else:
        for a in args:
            lines.append("%s : %s" % (a, typ))
            lines.append(_wrap(argdocs.get(a) or _GENERIC_ARGS.get(a)
                               or "Input %s." % a))
    for pname, f in op.param_fields.items():
        if pname == "__kwargs__" and op.name != "Custom":
            continue
        lines.append(_field_header(pname, f))
        lines.append(_wrap(pdocs.get(pname) or f.doc
                           or "Parameter %s." % pname))
    if kind == "symbol":
        lines.append("name : string, optional")
        lines.append(_wrap("Name of the resulting symbol (auto-generated "
                           "when omitted)."))
        lines.append("attr : dict of string to string, optional")
        lines.append(_wrap("Attributes attached to the symbol's node."))
    else:
        lines.append("out : %s, optional" % typ)
        lines.append(_wrap("Write the result into this array instead of "
                           "allocating a new one."))
    lines += ["", "Returns", "-------"]
    if len(outs) == 1:
        lines.append("%s : %s" % (outs[0], typ))
        lines.append(_wrap("The resulting %s." % typ.lower()))
    else:
        for o in outs:
            lines.append("%s : %s" % (o, typ))
            lines.append(_wrap("Output %s." % o))
    if aux:
        lines += ["", "Auxiliary states", "----------------"]
        for a in aux:
            lines.append(_wrap("%s (updated during training)" % a, indent=""))
    return "\n".join(lines)


def apply_to(op):
    """Copy the prose table onto one live OpDef: op.doc gets the summary
    (keeping any richer existing text) and each Field gets its doc.
    Called from registry.register() so late registrations (Custom,
    plugin ops) are covered too.

    Fields may be SHARED between ops (e.g. Convolution and Deconvolution
    build their params from one dict whose Field objects are not
    copied), so a documented Field is replaced with a per-op copy rather
    than mutated — otherwise one op's prose would overwrite another's."""
    from .registry import Field

    summary, pdocs = OPDOC.get(op.name, (None, {}))
    if summary and not op.doc:
        op.doc = summary
    for pname, text in pdocs.items():
        f = op.param_fields.get(pname)
        if f is not None and not f.doc:
            op.param_fields[pname] = Field(
                f.type, default=f.default, required=f.required,
                enum=f.enum, doc=text)


