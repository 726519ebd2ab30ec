"""Executor: a Symbol bound to arrays on one device.

Counterpart of ``mxnet_tpu/executor.py``. The JAX package traces the
graph into jitted programs (forward, and forward+backward through
``jax.vjp``); here the graph is evaluated node by node in topological
order on ``torch.Tensor``s, and gradients come from ``torch.autograd``:

- ``forward(is_train=True)`` with arguments to differentiate runs the
  graph with autograd recording, over leaves that share storage with
  the bound argument arrays, and keeps the graph for ``backward``;
  ``forward(is_train=False)`` records nothing. Aux states (BatchNorm's
  moving stats) are written, in place, only when ``is_train``.
- ``backward(out_grads=None)`` seeds loss heads (``no_head_grad`` ops,
  whose backward ignores the seed) with ones and other heads with
  ``out_grads``, takes the gradients of the ``grad_req`` write/add
  arguments, and writes them into ``grad_arrays`` (write) or adds them
  (add); ``null`` arguments get none. As in the JAX package the
  gradients of a loss-headed graph are cached against the argument and
  aux versions, so a second ``backward`` without a new forward applies
  them again (``grad_req="add"`` then accumulates); if an argument was
  written since the forward, ``backward`` recomputes the forward
  (without writing aux) first.
- ``arg_dict``/``grad_dict``/``aux_dict`` arrays are the bound arrays:
  ``exe.arg_dict["data"][:] = x`` is what the next forward reads.

- ``simple_bind(shared_exec=...)`` (bucketing's shared memory,
  ``mxnet_tpu/executor.py:1043-1113``) reuses the shared executor's
  argument, gradient and aux NDArray objects by name where shape and
  dtype match and allocates the rest; a gradient is shared only where
  both sides have ``grad_req="write"``. Every forward and backward reads
  ``arg_arrays[i]._data`` afresh and SGD updates in place, so one
  bucket's update is what the next bucket reads. ``reshape`` binds the
  same graph at new shapes over the same parameter arrays.
- ``set_monitor_callback(cb)`` taps every op output during ``forward``,
  in node order, as ``cb("%s_%s" % (node, output), NDArray)``: the walk
  is node by node already, so the taps are inline (the JAX package
  replays the graph eagerly for them).
- Random ops (``need_rng``: Dropout, RNN) get the JAX package's keys
  (``mxnet_tpu/executor.py:633-636``, ``:856``): each
  ``forward(is_train=True)`` takes one key from ``random.next_key()``
  and a node's key is ``fold_in(key, serial)``, ``serial`` being its
  index in the topological order, which is the JAX executor's
  ``_nodes`` order; inference takes none. A tapped forward takes one
  more key first, as the JAX package's monitor replay does
  (``:789``), so the chains stay in step. ``backward`` runs on the
  forward's autograd graph, so its masks are the forward's, and takes
  no key; only where it must run the forward again (an argument was
  written since) does it take one, as the JAX package's does. With
  explicit ``out_grads`` the JAX package's ``backward`` always runs the
  forward again under a fresh key (``:971``): its gradients then come
  from other masks than its outputs, and the two chains part.

- Host ops (``Custom``, ``NumpyOp``: ``OpDef.is_host_op``) run in the
  walk through ``ops.registry._HostOpFn``, the counterpart of the JAX
  package's hybrid engine (``mxnet_tpu/executor.py:256-518``): inputs to
  the host as numpy, the user's forward there, outputs back to the
  device; autograd runs the user's backward. The JAX package's contract
  for such a graph holds here too:

  - one user operator per (node, input signature) for the executor's
    life (``_host_op_cache``, ``mxnet_tpu/executor.py:190-211``), so a
    stateful operator keeps its state across batches;
  - a host op with loss semantics (a prop with ``need_top_grad=False``)
    runs its backward even where no gradient reached its outputs
    (``:457-466``): its outputs are extra roots of the backward, seeded
    with zeros;
  - ``backward`` differentiates the forward it saved and never runs the
    forward again (a second draw of a stateful operator): the training
    forward works on copies of the arguments, so an argument written
    since leaves the gradients as they were; ``backward`` after an
    inference forward, or a second ``backward`` after one forward,
    raises, as the JAX package's does (``:437``, ``:518``);
  - ``forward(is_train=...)`` reaches the user's op as given, and the
    monitor taps host-op outputs like any other.

- Mirroring (gradient checkpointing, ``mxnet_tpu/executor.py:521-600``):
  nodes tagged ``force_mirroring``, every node under
  ``MXNET_BACKWARD_DO_MIRROR=1``, or the nodes whose op name matches
  ``MXNET_BACKWARD_MIRROR_PATTERN`` (a regex) are grouped, at bind
  time, into segments of ``MXNET_BACKWARD_MIRROR_STEP`` consecutive
  nodes (0: the square root of the run's length), the JAX executor's
  plan. In a training forward that records autograd each segment runs
  under ``torch.utils.checkpoint`` (non-reentrant): its activations are
  not kept but recomputed in the backward, from the segment's inputs,
  under the same per-node keys, so masks, outputs and gradients are
  the unmirrored graph's. A segment returns its new aux states; the
  recompute's are dropped. Monitor taps fire in the first run only. A
  loss head that ends a segment runs after its checkpointed part (its
  output is kept anyway), so SoftmaxOutput's K1 runs once a step.
  Host ops never enter a segment, and neither does a ``TorchModule``
  or ``TorchCriterion`` whose module holds buffers or a Dropout: each
  closes the segment before it, so a user's forward runs once a step.

- Model parallelism (``group2ctx``, ``mxnet_tpu/executor.py:127``,
  ``:176-182``): a node whose ``ctx_group`` attribute names a group of
  ``group2ctx`` runs on that group's context, every other node on the
  bind context. Argument and gradient arrays live on their variable's
  context and aux states on their op's (``simple_bind`` allocates them
  there; ``bind`` checks them), heads come out on their node's context,
  and a value crossing a group boundary is copied to its consumer's
  device with ``Tensor.to``, which autograd differentiates, so the
  gradients travel back across the same boundary. A copy between cards
  runs on the source card's current stream after the destination's
  current stream has caught up, and the destination's stream waits for
  it (torch's device-to-device copy), so the next kernel reads it
  complete. On the host every context is the one CPU device: there the
  contexts are bookkeeping and no copy happens.

- Telemetry (``MXNET_TELEMETRY=1``): ``executor.forward_secs`` and
  ``executor.backward_secs`` histograms of every call, and
  ``executor.jit_builds_total`` counting the three entry points
  (inference, training, training with gradients) a bind prepares, as
  the JAX executor counts its three programs. mxprof (``MXNET_PROF=1``,
  ``mxnet_tpu/executor.py:682-727``): each entry point's first call
  records its analytic cost (``telemetry/prof.py``), keyed as the JAX
  executor keys it, and its peak device memory; graphs with host ops
  and model-parallel binds are not attributed, as in the JAX package.

- The compile layer (``compile/``, ``mxnet_tpu/executor.py:127-155``):
  with ``MXNET_COMPILE_OPT=1`` the bind rewrites the graph before the
  walk (fold, layout, fuse, precision) and the executor walks the
  rewritten graph, ``_exec_symbol``; argument and aux mapping key off
  the original graph's variable nodes, which the passes keep by
  identity, and loss-head semantics come from the user's graph.
  Binds with ``group2ctx`` are not rewritten (placement is per original
  node). A failing pass falls back to the unrewritten graph with a
  warning, except ``CompileVerifyError`` (``MXNET_COMPILE_VERIFY=1``),
  which propagates. Every bind arms the persistent cubin cache when
  ``MXNET_COMPILE_CACHE_DIR`` is set. Under ``MXNET_JIT_VERIFY`` the
  three entry points are boundaries of ``analysis/compile_verify.py``
  (``executor.fwd_infer``, ``executor.fwd_train``,
  ``executor.fwd_bwd``, budget 2 each, group ``executor.bind``), as in
  the JAX executor; host-op and model-parallel binds are not wrapped.
"""
from __future__ import annotations

import functools
import logging
import math
import os
import re
import time as _time

import torch
from torch.utils.checkpoint import checkpoint

from . import compile as _compile
from . import random as _random
from . import telemetry as _tel
from . import threefry
from .analysis import compile_verify as _cv
from .base import (MXNetError, deterministic_grads, env_bool, env_int,
                   torch_dtype)
from .context import Context
from .ndarray import NDArray, _as_tensor, ones, zeros
from .telemetry import prof as _prof

__all__ = ["Executor"]


def _as_req_list(grad_req, arg_names):
    if isinstance(grad_req, str):
        return [grad_req] * len(arg_names)
    if isinstance(grad_req, (list, tuple)):
        return list(grad_req)
    if isinstance(grad_req, dict):
        return [grad_req.get(n, "null") for n in arg_names]
    raise MXNetError("invalid grad_req %r" % (grad_req,))


def _node_contexts(symbol, ctx, group2ctx):
    """id(node) -> the context it runs on: its ``ctx_group``'s in
    ``group2ctx``, else the bind context."""
    out = {}
    for n in symbol.nodes:
        grp = n.attrs.get("ctx_group") if group2ctx else None
        out[id(n)] = group2ctx.get(grp, ctx) if grp else ctx
    return out


def _arg_contexts(symbol, node_ctx):
    """Each argument's context: its variable node's, in argument order."""
    return [node_ctx[id(n)] for n in symbol.nodes if n.is_variable]


def _aux_contexts(symbol, node_ctx):
    """Each aux state's context: the op node's that owns it, in aux
    order."""
    return [node_ctx[id(n)] for n in symbol.nodes if not n.is_variable
            for _ in n.op.list_auxiliary_states(n.params)]


class Executor:
    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None,
                 _compile_opts=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._device = self._ctx.torch_device
        self._group2ctx = dict(group2ctx or {})
        self._node_ctx = _node_contexts(symbol, self._ctx, self._group2ctx)
        self._multi_device = len(
            {c.torch_device for c in self._node_ctx.values()}) > 1

        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

        if isinstance(args, dict):
            missing = [n for n in self._arg_names if n not in args]
            if missing:
                raise MXNetError("bind: missing arguments %s" % missing)
            self.arg_arrays = [args[n] for n in self._arg_names]
        else:
            if len(args) != len(self._arg_names):
                raise MXNetError("bind: expected %d args, got %d"
                                 % (len(self._arg_names), len(args)))
            self.arg_arrays = list(args)

        if args_grad is None:
            self.grad_arrays = [None] * len(self._arg_names)
        elif isinstance(args_grad, dict):
            self.grad_arrays = [args_grad.get(n) for n in self._arg_names]
        else:
            self.grad_arrays = list(args_grad)
            while len(self.grad_arrays) < len(self._arg_names):
                self.grad_arrays.append(None)

        self._reqs = _as_req_list(grad_req, self._arg_names)
        for i, (g, r) in enumerate(zip(self.grad_arrays, self._reqs)):
            if g is None and r != "null":
                self._reqs[i] = "null"

        if aux_states is None:
            if self._aux_names:
                _, _, aux_shapes = symbol.infer_shape(
                    **{n: a.shape for n, a in zip(self._arg_names,
                                                  self.arg_arrays)})
                if aux_shapes is None or any(s is None for s in aux_shapes):
                    raise MXNetError("bind: aux_states required (shapes "
                                     "underdetermined)")
                self.aux_arrays = [zeros(s, c) for s, c in zip(
                    aux_shapes, _aux_contexts(symbol, self._node_ctx))]
            else:
                self.aux_arrays = []
        elif isinstance(aux_states, dict):
            self.aux_arrays = [aux_states[n] for n in self._aux_names]
        else:
            self.aux_arrays = list(aux_states)

        arg_ctx = _arg_contexts(symbol, self._node_ctx)
        aux_ctx = _aux_contexts(symbol, self._node_ctx)
        for kind, arrs, ctxs in (("argument", self.arg_arrays, arg_ctx),
                                 ("gradient", self.grad_arrays, arg_ctx),
                                 ("aux state", self.aux_arrays, aux_ctx)):
            for a, c in zip(arrs, ctxs):
                if a is not None and a._data.device != c.torch_device:
                    raise MXNetError("bind: %s array on %s, its node on %s"
                                     % (kind, a._data.device, c))

        # argument mapping keys off the ORIGINAL symbol's variable nodes;
        # the compile passes keep variable objects by identity, so the
        # same map serves the rewritten graph
        self._var_argidx = {}
        ai = 0
        for n in symbol.nodes:
            if n.is_variable:
                self._var_argidx[id(n)] = ai
                ai += 1
        self._exec_symbol = symbol
        if _compile.ENABLED and not self._group2ctx:
            try:
                self._exec_symbol = _compile.optimize(
                    symbol,
                    input_shapes={n: a.shape for n, a in
                                  zip(self._arg_names, self.arg_arrays)},
                    input_types={n: a.dtype for n, a in
                                 zip(self._arg_names, self.arg_arrays)
                                 if a.dtype is not torch.bfloat16},
                    device=self._device, **dict(_compile_opts or {}))
            except _compile.CompileVerifyError:
                raise
            except Exception as e:
                logging.getLogger("mxnet_tpu_torch.compile").warning(
                    "graph rewrite failed (%s: %s); binding the "
                    "unrewritten graph", type(e).__name__, e)
                self._exec_symbol = symbol
        self._nodes = self._exec_symbol.nodes
        for n in self._nodes:   # nodes the rewrite made run on the bind ctx
            self._node_ctx.setdefault(id(n), self._ctx)
        self._node_aux = {}
        pos = 0
        for n in self._nodes:
            if n.is_variable:
                continue
            na = len(n.op.list_auxiliary_states(n.params))
            if na:
                self._node_aux[id(n)] = (pos, pos + na)
                pos += na
        nid = {id(n): i for i, n in enumerate(self._nodes)}
        self._heads = [(nid[id(nd)], i)
                       for nd, i in self._exec_symbol._outputs]
        # loss-head semantics come from the USER's graph (rewrites never
        # wrap loss heads)
        self._head_no_grad = [
            (not nd.is_variable) and nd.op.head_no_grad(nd.params)
            for nd, _ in symbol._outputs]
        self._grad_idx = [i for i, r in enumerate(self._reqs) if r != "null"]
        self._release = self._plan_release()
        # gradient checkpointing ("mirror"): read at bind, as the JAX
        # executor does
        self._node_plan = [("node", i) for i in range(len(self._nodes))]
        self._plan = self._build_mirror_plan()
        self._remat = any(item[0] == "seg" for item in self._plan)
        self._seg_runs = [self._split_segment(item) if item[0] == "seg"
                          else None for item in self._plan]
        self._rng_serials = [s for s, n in enumerate(self._nodes)
                             if not n.is_variable and n.op.need_rng]

        self._hybrid = any(not n.is_variable and n.op.is_host_op
                           for n in self._nodes)
        self._host_op_cache = {}   # user operators of this binding
        self._host_roots = []      # loss-semantics host outputs, last walk
        # persistent cubin cache (MXNET_COMPILE_CACHE_DIR): no-op when
        # unconfigured
        _compile.ensure_jit_cache()
        # the three entry points; verifier boundaries under
        # MXNET_JIT_VERIFY (the walk itself otherwise). Budget 2: the key
        # is None or a tensor, and the recompute of a backward writes no
        # aux — two legal signatures each
        self._fwd_infer = functools.partial(self._run, is_train=False)
        self._fwd_train = functools.partial(self._run, is_train=True)
        self._fwd_bwd = self._forward_graph
        if not (self._hybrid or self._multi_device or self._group2ctx):
            self._fwd_infer = _cv.wrap(
                "executor.fwd_infer", self._fwd_infer, budget=2,
                group="executor.bind")
            self._fwd_train = _cv.wrap(
                "executor.fwd_train", self._fwd_train, budget=2,
                group="executor.bind")
            self._fwd_bwd = _cv.wrap(
                "executor.fwd_bwd", self._fwd_bwd, budget=2,
                group="executor.bind")

        self._outputs_nd = None
        self._graph = None       # (versions, output tensors, leaves, roots)
        self._grad_cache = None  # (versions, grads)
        # mxprof: entry points attributed lazily at first dispatch
        self._prof_done = set()
        self._prof_analytic_memo = None
        self._prof_ghash = None
        if _tel.ENABLED and not self._hybrid:
            # the JAX bind's three programs (fwd_infer, fwd_train,
            # fwd_bwd): each bind prepares them afresh
            _tel.counter("executor.jit_builds_total").inc(3)
        self._monitor_callback = None

    def _plan_release(self):
        """serial -> env keys whose last reader is that node, so the
        walk drops an intermediate as soon as nothing else reads it."""
        last = {}
        for serial, n in enumerate(self._nodes):
            for s, i in n.inputs:
                last[(id(s), i)] = serial
        heads = {(id(self._nodes[i]), j) for i, j in self._heads}
        release = {}
        for key, serial in last.items():
            if key not in heads:
                release.setdefault(serial, []).append(key)
        return release

    # -- mirror (gradient checkpointing) planning --------------------------
    def _graph_meta(self):
        head_keys = {(id(self._nodes[i]), j) for i, j in self._heads}
        consumers = {}
        for serial, n in enumerate(self._nodes):
            if n.is_variable:
                continue
            for s, i in n.inputs:
                consumers.setdefault((id(s), i), set()).add(serial)
        return head_keys, consumers

    def _segment_item(self, chunk, head_keys, consumers):
        """``("seg", serials, external inputs, live outputs, aux window,
        random serials)`` of one segment, as the JAX executor's."""
        seg_set = set(chunk)
        produced = []
        for s in chunk:
            n = self._nodes[s]
            for i in range(len(n.op.list_outputs(n.params))):
                produced.append((id(n), i))
        produced_set = set(produced)
        ext, seen = [], set()
        for s in chunk:
            for src, i in self._nodes[s].inputs:
                k = (id(src), i)
                if k not in produced_set and k not in seen:
                    seen.add(k)
                    ext.append(k)
        outs = [k for k in produced
                if k in head_keys or (consumers.get(k, set()) - seg_set)]
        aux_ids = [j for s in chunk
                   for j in range(*self._node_aux.get(id(self._nodes[s]),
                                                      (0, 0)))]
        rng_serials = [s for s in chunk if self._nodes[s].op.need_rng]
        return ("seg", tuple(chunk), tuple(ext), tuple(outs),
                tuple(aux_ids), tuple(rng_serials))

    def _build_mirror_plan(self):
        """``("node", serial)`` and segment items in topological order:
        the JAX executor's ``_build_mirror_plan``, except that a node
        that must run once a step (:meth:`_recomputable` false) closes
        the open run instead of joining it."""
        mirror_all = env_bool("MXNET_BACKWARD_DO_MIRROR", False)
        pattern = os.environ.get("MXNET_BACKWARD_MIRROR_PATTERN", "")
        pat = re.compile(pattern) if pattern else None
        mirror_step = env_int("MXNET_BACKWARD_MIRROR_STEP", 0)

        def mirrored(n):
            if n.is_variable or not self._recomputable(n):
                return False
            a = n.attrs.get("force_mirroring")
            if a is not None:
                return str(a).lower() in ("true", "1")
            if pat is not None and pat.search(n.op.name):
                return True
            return mirror_all

        if not any(mirrored(n) for n in self._nodes):
            return self._node_plan
        head_keys, consumers = self._graph_meta()
        plan, run = [], []

        def flush():
            if not run:
                return
            step = mirror_step or max(1, int(math.sqrt(len(run))))
            for lo in range(0, len(run), step):
                plan.append(self._segment_item(
                    tuple(run[lo:lo + step]), head_keys, consumers))
            run.clear()

        for serial, n in enumerate(self._nodes):
            if mirrored(n):
                run.append(serial)
            elif n.is_variable:
                # an env load: emitted ahead of the open run, not closing it
                plan.append(("node", serial))
            else:
                flush()
                plan.append(("node", serial))
        flush()
        return plan

    def _split_segment(self, item):
        """(the part of a segment that runs under ``checkpoint``, as a
        segment item or None, and the serials after it): the loss heads
        that end a segment run after the checkpointed part, since their
        outputs are the graph's and kept anyway; recomputing them would
        only launch their kernels (SoftmaxOutput's K1) a second time."""
        serials = list(item[1])
        heads = {id(self._nodes[i]) for i, _ in self._heads}
        tail = []
        while serials:
            n = self._nodes[serials[-1]]
            if not (id(n) in heads and n.op.head_no_grad(n.params)):
                break
            tail.insert(0, serials.pop())
        if not tail:
            return item, ()
        if not serials:
            return None, tuple(tail)
        return self._segment_item(tuple(serials), *self._graph_meta()), \
            tuple(tail)

    @staticmethod
    def _recomputable(n):
        """Whether running ``n`` a second time, in the backward, is
        invisible: not for a host op (the user's operator would run its
        forward twice), nor for a torch module with buffers or a
        Dropout of its own."""
        if n.op.is_host_op:
            return False
        if n.op.name in ("TorchModule", "TorchCriterion"):
            from .torch import _resolve_module_string, module_creator

            mod = module_creator(_resolve_module_string(n.params))
            return not (any(True for _ in mod.buffers()) or any(
                isinstance(m, torch.nn.modules.dropout._DropoutNd)
                for m in mod.modules()))
        return True

    # -- the graph walk --------------------------------------------------------
    def _node_keys(self, key):
        """serial -> ``fold_in(key, serial)`` on the executor's device for
        every random node, derived together on the host."""
        if key is None or not self._rng_serials:
            return {}
        keys = threefry.fold_in(key, torch.tensor(self._rng_serials))
        return dict(zip(self._rng_serials,
                        _random.keys_to(keys, self._device).unbind(0)))

    def _apply_node(self, serial, env, aux, rng, is_train, monitor):
        """Evaluate one op node into ``env``; ``aux`` is indexed by the
        global aux position (the walk's list, or a segment's dict)."""
        n = self._nodes[serial]
        ins = [env[(id(s), i)] for s, i in n.inputs]
        if self._multi_device:
            # a group boundary: the consumer's device (autograd carries
            # the gradient back through the copy)
            dev = self._node_ctx[id(n)].torch_device
            ins = [x.to(dev) for x in ins]
            if rng is not None:
                rng = rng.to(dev)
        sl = self._node_aux.get(id(n))
        aux_in = [aux[j] for j in range(*sl)] if sl else []
        outs, n_aux = n.op.apply(n.params, ins, aux_in, is_train, rng,
                                 host_cache=self._host_op_cache)
        onames = n.op.list_outputs(n.params) if monitor else ()
        for i, o in enumerate(outs):
            env[(id(n), i)] = o
            if monitor is not None:
                monitor("%s_%s" % (n.name, onames[i]),
                        NDArray(o.detach(), self._node_ctx[id(n)]))
        if sl:
            for j, v in zip(range(*sl), n_aux):
                aux[j] = v
        return outs

    def _run(self, arg_vals, aux_vals, is_train, tap=False, key=None):
        """Walk the graph; random nodes draw under ``key``; with ``tap``
        every op output goes to the monitor callback as it is made. A
        training forward that records autograd runs the mirror plan's
        segments under ``checkpoint``."""
        env = {}
        new_aux = list(aux_vals)
        monitor = self._monitor_callback if tap else None
        node_keys = self._node_keys(key)
        self._host_roots = roots = []
        recording = torch.is_grad_enabled()
        plan = self._plan if (self._remat and is_train and recording) \
            else self._node_plan
        for idx, item in enumerate(plan):
            if item[0] == "seg":
                body, tail = self._seg_runs[idx]
                if body is not None:
                    self._run_segment(body, env, new_aux, node_keys,
                                      is_train, monitor)
                for serial in tail:
                    self._apply_node(serial, env, new_aux,
                                     node_keys.get(serial), is_train,
                                     monitor)
                serials = item[1]
            else:
                serial = item[1]
                serials = (serial,)
                n = self._nodes[serial]
                if n.is_variable:
                    env[(id(n), 0)] = arg_vals[self._var_argidx[id(n)]]
                    continue
                outs = self._apply_node(serial, env, new_aux,
                                        node_keys.get(serial), is_train,
                                        monitor)
                if recording and n.op.is_host_op and \
                        n.op.head_no_grad(n.params):
                    roots.extend(o for o in outs if o.requires_grad)
            for serial in serials:
                for k in self._release.get(serial, ()):
                    env.pop(k, None)
        outputs = [env[(id(self._nodes[i]), j)] for i, j in self._heads]
        return outputs, new_aux

    def _run_segment(self, item, env, new_aux, node_keys, is_train,
                     monitor):
        """One mirror segment under ``torch.utils.checkpoint``: its
        external inputs, aux window and node keys go in, its live
        outputs and new aux states come out; the backward runs the
        segment again from the same inputs and keys (no taps then) for
        the activations it did not keep."""
        _, serials, ext_keys, out_keys, aux_ids, rng_serials = item
        n_ext, n_aux = len(ext_keys), len(aux_ids)
        first = [True]
        # the recompute picks cuDNN's algorithms as the forward did (the
        # backward runs under deterministic_grads)
        cudnn = torch.backends.cudnn
        deterministic = cudnn.deterministic

        def seg_fn(*vals):
            local = dict(zip(ext_keys, vals[:n_ext]))
            laux = dict(zip(aux_ids, vals[n_ext:n_ext + n_aux]))
            keys = dict(zip(rng_serials, vals[n_ext + n_aux:]))
            tap = monitor if first[0] else None
            first[0] = False
            saved, cudnn.deterministic = cudnn.deterministic, deterministic
            try:
                for s in serials:
                    self._apply_node(s, local, laux, keys.get(s), is_train,
                                     tap)
            finally:
                cudnn.deterministic = saved
            return tuple([local[k] for k in out_keys]
                         + [laux[j] for j in aux_ids])

        # the aux states go in as copies: the forward's caller writes the
        # new states into the bound ones in place before the backward
        # recomputes from its inputs
        vals = ([env[k] for k in ext_keys]
                + [new_aux[j].detach().clone() for j in aux_ids]
                + [node_keys.get(s) for s in rng_serials])
        # the ops draw from their keys, never from torch's generators
        got = checkpoint(seg_fn, *vals, use_reentrant=False,
                         preserve_rng_state=False)
        env.update(zip(out_keys, got[:len(out_keys)]))
        for j, v in zip(aux_ids, got[len(out_keys):]):
            new_aux[j] = v

    def _forward_graph(self, vals, aux_vals, key, write_aux, tap=False):
        """Forward with autograd recording over the differentiated
        arguments ``vals`` (the bound arrays' tensors), random nodes
        under ``key``; keeps (versions, outputs, leaves, host roots) for
        backward. A graph with host ops reads copies of the arguments
        (see the module's docstring)."""
        vals = list(vals)
        if self._hybrid:
            vals = [v.detach().clone() for v in vals]
        leaves = []
        for i in self._grad_idx:
            leaf = vals[i].detach().requires_grad_(
                vals[i].is_floating_point())
            vals[i] = leaf
            leaves.append(leaf)
        with torch.enable_grad():
            outs, new_aux = self._run(vals, aux_vals, True, tap, key)
        self._write_outputs(outs)
        if write_aux:
            self._write_aux(new_aux)
        self._graph = (self._versions(), outs, leaves, self._host_roots)

    # -- helpers ---------------------------------------------------------------
    def _release_device_arrays(self):
        """Drop this executor's argument, gradient and aux arrays and keep
        ``_run`` usable as a function of its arguments: the trainers that
        borrow ``_run`` (``parallel/symbol_trainer.py``,
        ``parallel/fit_trainer.py``) keep their own parameters, so the
        bound method must not pin a second set on the device. The
        executor cannot forward or backward afterwards."""
        self.arg_arrays = self.grad_arrays = self.aux_arrays = None
        self._outputs_nd = None

    def _aux_vals(self):
        return [a._data for a in self.aux_arrays]

    def _versions(self):
        return tuple(a.version for a in self.arg_arrays) + tuple(
            a.version for a in self.aux_arrays)

    def _write_outputs(self, outs):
        outs = [o.detach() for o in outs]
        if self._outputs_nd is None:
            self._outputs_nd = [
                NDArray(o, self._node_ctx[id(self._nodes[i])])
                for o, (i, _) in zip(outs, self._heads)]
        else:
            for nd, o in zip(self._outputs_nd, outs):
                nd._data = o

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for nd, v in zip(self.aux_arrays, new_aux):
                if v is not nd._data:
                    nd._data.copy_(v)

    def _default_head_grads(self):
        """Ones for loss heads, zeros for others, None for integer
        heads (no gradient exists)."""
        if self._outputs_nd is None:
            raise MXNetError("backward before forward")
        hg = []
        for out_nd, no_grad in zip(self._outputs_nd, self._head_no_grad):
            t = out_nd._data
            if not t.is_floating_point():
                hg.append(None)
                continue
            hg.append(torch.ones_like(t) if no_grad else torch.zeros_like(t))
        return hg

    # -- public API ------------------------------------------------------------
    @property
    def outputs(self):
        if self._outputs_nd is None:
            self.forward(is_train=False)
        return self._outputs_nd

    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._output_names, self.outputs))

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` are written into the named argument
        arrays first. mxtel: per-call walltime lands in
        ``executor.forward_secs``."""
        if _prof.ENABLED:
            tag = ("fwd_bwd" if is_train and self._grad_idx
                   and all(self._head_no_grad)
                   else "fwd_train" if is_train else "fwd_infer")
            key = self._prof_attribute(tag)
            if key is not None:
                with _prof.measure_first_call(key, self._device):
                    return self._timed_forward(is_train, **kwargs)
        return self._timed_forward(is_train, **kwargs)

    def _timed_forward(self, is_train, **kwargs):
        if not _tel.ENABLED:
            return self._forward_impl(is_train, **kwargs)
        t0 = _time.monotonic()
        try:
            return self._forward_impl(is_train, **kwargs)
        finally:
            _tel.histogram("executor.forward_secs").observe(
                _time.monotonic() - t0)

    # -- mxprof attribution ----------------------------------------------------
    def _prof_analytic(self):
        """Analytic DAG cost for this bind (memoized)."""
        if self._prof_analytic_memo is None:
            try:
                self._prof_analytic_memo = _prof.graph_cost(
                    self._symbol,
                    {n: a.shape for n, a in zip(self._arg_names,
                                                self.arg_arrays)},
                    {n: a._data.dtype for n, a in zip(self._arg_names,
                                                      self.arg_arrays)})
            except Exception:
                self._prof_analytic_memo = {}
        return self._prof_analytic_memo or None

    def _prof_attribute(self, tag):
        """Record entry point ``tag``'s cost on its first call (the
        training-with-gradients one at ~3x the forward FLOPs); returns
        its program key then, else None. Host-op graphs and
        model-parallel binds are not attributed."""
        if tag in self._prof_done or self._hybrid or self._multi_device \
                or self.arg_arrays is None:
            return None
        self._prof_done.add(tag)
        sig = ",".join(
            "%s=%s:%s" % (n, "x".join(str(d) for d in a.shape),
                          str(a._data.dtype).replace("torch.", ""))
            for n, a in zip(self._arg_names, self.arg_arrays))
        if self._prof_ghash is None:
            self._prof_ghash = "%s|req=%s" % (
                _prof.symbol_fingerprint(self._symbol), ",".join(self._reqs))
        an = self._prof_analytic()
        flops = None
        if an:
            flops = an["flops_train"] if tag == "fwd_bwd" else an["flops"]
        key = "executor|%s|%s" % (tag, sig)
        _prof.attribute_program(
            key, self._forward_impl, site="executor.%s" % tag, analytic=an,
            meta={"outputs": self._output_names}, graph_key=self._prof_ghash,
            flops=flops)
        return _prof.program_key_for(key, graph_key=self._prof_ghash)

    def _forward_impl(self, is_train=False, **kwargs):
        if kwargs:
            arg_dict = self.arg_dict
            for k, v in kwargs.items():
                if k not in arg_dict:
                    raise MXNetError("forward: unknown argument %s" % k)
                if isinstance(v, NDArray):
                    v.copyto(arg_dict[k])
                else:
                    arg_dict[k][:] = v
        self._graph = None
        self._grad_cache = None
        if self._monitor_callback is not None:
            _random.next_key()   # the JAX package's monitor replay's key
        key = _random.next_key() if is_train else None
        if is_train and self._grad_idx:
            self._fwd_bwd([a._data for a in self.arg_arrays],
                          self._aux_vals(), key, True, tap=True)
        else:
            run = self._fwd_train if is_train else self._fwd_infer
            with torch.no_grad():
                outs, new_aux = run(
                    [a._data for a in self.arg_arrays], self._aux_vals(),
                    tap=True, key=key)
            self._write_outputs(outs)
            if is_train:
                self._write_aux(new_aux)
        return self.outputs

    def backward(self, out_grads=None):
        """Gradients into ``grad_arrays`` per ``grad_req``; without
        ``out_grads`` every head must be a loss op. mxtel: per-call
        walltime lands in ``executor.backward_secs``."""
        if not _tel.ENABLED:
            return self._backward_impl(out_grads)
        t0 = _time.monotonic()
        try:
            return self._backward_impl(out_grads)
        finally:
            _tel.histogram("executor.backward_secs").observe(
                _time.monotonic() - t0)

    def _backward_impl(self, out_grads=None):
        if not self._grad_idx:
            return
        if out_grads is None:
            if not all(self._head_no_grad):
                raise MXNetError(
                    "backward() without out_grads requires loss-op heads; "
                    "pass out_grads for outputs %s"
                    % [n for n, ng in zip(self._output_names,
                                          self._head_no_grad) if not ng])
            if self._grad_cache is not None and \
                    self._grad_cache[0] == self._versions():
                self._apply_grads(self._grad_cache[1])
                return
            if self._outputs_nd is None:
                self.forward(is_train=False)
            hg = self._default_head_grads()
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if isinstance(out_grads, dict):
                out_grads = [out_grads[n] for n in self._output_names]
            if self._outputs_nd is None:
                self.forward(is_train=False)
            hg = [None if not o._data.is_floating_point()
                  else _as_tensor(g, o._data.device, o._data.dtype)
                  for g, o in zip(out_grads, self._outputs_nd)]
        if self._hybrid:
            if self._graph is None:
                raise MXNetError("backward before forward(is_train=True)")
        elif self._graph is None or self._graph[0] != self._versions():
            self._fwd_bwd([a._data for a in self.arg_arrays],
                          self._aux_vals(), _random.next_key(), False)
        _, outs, leaves, roots = self._graph
        self._graph = None
        pairs = [(o, g) for o, g in zip(outs, hg)
                 if g is not None and o.requires_grad]
        pairs += [(o, torch.zeros_like(o)) for o in roots]
        diff = [k for k, leaf in enumerate(leaves) if leaf.requires_grad]
        grads = [None] * len(leaves)
        if pairs and diff:
            with deterministic_grads():
                got = torch.autograd.grad(
                    [o for o, _ in pairs], [leaves[k] for k in diff],
                    [g for _, g in pairs], allow_unused=True)
            for k, g in zip(diff, got):
                grads[k] = g
        grads = [torch.zeros_like(leaf) if g is None else g
                 for g, leaf in zip(grads, leaves)]
        if out_grads is None and not self._hybrid:
            self._grad_cache = (self._versions(), grads)
        self._apply_grads(grads)

    def _apply_grads(self, grads):
        with torch.no_grad():
            for slot, i in enumerate(self._grad_idx):
                tgt = self.grad_arrays[i]._data
                g = grads[slot].to(tgt.dtype)
                if self._reqs[i] == "write":
                    tgt.copy_(g)
                elif self._reqs[i] == "add":
                    tgt.add_(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                arr.copyto(self.arg_dict[name])
            elif not allow_extra_params:
                raise MXNetError("copy_params_from: %s not an argument"
                                 % name)
        if aux_params:
            for name, arr in aux_params.items():
                if name in self.aux_dict:
                    arr.copyto(self.aux_dict[name])
                elif not allow_extra_params:
                    raise MXNetError("copy_params_from: %s not an aux state"
                                     % name)

    def set_monitor_callback(self, callback):
        """``callback(name, NDArray)`` for every op output of every
        forward (ref: python/mxnet/executor.py:86)."""
        self._monitor_callback = callback

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor of the same graph at the shapes ``kwargs``
        give, over this one's arrays where the shape holds (the
        parameters) and fresh zeros where it does not (the data), as
        ``mxnet_tpu/executor.py:1007-1035`` does; ``partial_shaping`` and
        ``allow_up_sizing`` are accepted and not checked, there too."""
        arg_shapes, _, _ = self._symbol.infer_shape_partial(**kwargs)
        arg_dict = self.arg_dict
        new_args = {}
        for name, s in zip(self._arg_names, arg_shapes):
            cur = arg_dict[name]
            if s is not None and tuple(s) != cur.shape:
                new_args[name] = zeros(s, cur.context, cur.dtype)
            else:
                new_args[name] = cur
        new_grads = {}
        for n, g in zip(self._arg_names, self.grad_arrays):
            if g is None:
                continue
            tgt_shape = new_args[n].shape
            new_grads[n] = g if g.shape == tgt_shape else zeros(
                tgt_shape, g.context, g.dtype)
        return Executor(
            self._symbol, self._ctx, new_args,
            args_grad=new_grads or None,
            grad_req={n: r for n, r in zip(self._arg_names, self._reqs)},
            aux_states=self.aux_arrays, group2ctx=self._group2ctx)

    def debug_str(self):
        return self._symbol.debug_str()

    # -- simple_bind -----------------------------------------------------------
    @staticmethod
    def _simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                     group2ctx=None, shared_exec=None, **kwargs):
        """Allocate argument, gradient and aux arrays from inferred
        shapes (aux states named ``*var*`` start at one, the rest at
        zero), each on its node's context under ``group2ctx``. With
        ``shared_exec``, reuse its argument, gradient and aux NDArrays
        where name, shape, dtype and context match; a gradient only
        where both executors write it (an ``add`` accumulator stays
        private on both sides)."""
        ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        node_ctx = _node_contexts(symbol, ctx, dict(group2ctx or {}))
        arg_ctx = _arg_contexts(symbol, node_ctx)
        aux_ctx = _aux_contexts(symbol, node_ctx)
        arg_shapes, out_shapes, aux_shapes = symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("simple_bind: cannot infer shapes from %s"
                             % kwargs)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_types, _, aux_types = symbol.infer_type(**dict(type_dict or {}))
        if shared_exec is not None:
            shared_args = shared_exec.arg_dict
            shared_grads = shared_exec.grad_dict
            shared_aux = shared_exec.aux_dict
            shared_reqs = dict(zip(shared_exec._arg_names,
                                   shared_exec._reqs))
        else:
            shared_args = shared_grads = shared_aux = shared_reqs = {}

        def reuse(cand, shape, t, c):
            return (cand is not None and cand.shape == tuple(shape)
                    and cand._data.dtype == torch_dtype(t)
                    and cand.context == c)

        args = {}
        for name, shape, t, c in zip(arg_names, arg_shapes, arg_types,
                                     arg_ctx):
            cand = shared_args.get(name)
            args[name] = cand if reuse(cand, shape, t, c) else zeros(
                shape, c, dtype=t)
        reqs = _as_req_list(grad_req, arg_names)
        args_grad = {}
        for name, shape, t, r, c in zip(arg_names, arg_shapes, arg_types,
                                        reqs, arg_ctx):
            if r == "null":
                continue
            cand = shared_grads.get(name)
            if r == "write" and shared_reqs.get(name) == "write" and \
                    reuse(cand, shape, t, c):
                args_grad[name] = cand
            else:
                args_grad[name] = zeros(shape, c, dtype=t)
        aux_states = []
        for name, shape, t, c in zip(aux_names, aux_shapes, aux_types,
                                     aux_ctx):
            cand = shared_aux.get(name)
            aux_states.append(cand if reuse(cand, shape, t, c) else
                              (ones if "var" in name else zeros)(
                                  shape, c, dtype=t))
        return Executor(symbol, ctx, args, args_grad=args_grad or None,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec)
