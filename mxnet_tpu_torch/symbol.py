"""Symbol: declarative DAG of operators.

The port's copy of ``mxnet_tpu/symbol.py``. The graph, composition,
naming, shape and type inference and the JSON format are the JAX
package's, so ``tojson()``, ``infer_shape`` and the ``list_*`` results
are the same in both packages (``tests/test_torch_symbol.py``).
``bind``/``simple_bind`` hand the graph to the port's
:class:`~mxnet_tpu_torch.executor.Executor`, which evaluates it node by
node on ``torch.Tensor``s; ``optimize`` runs the compile layer's
rewrite passes (``compile/``). Not carried over: the ``lint`` pass, and
stream URIs in ``save``/``load`` (local paths only).

Op constructor functions (``sym.Convolution``, ...) are installed by
``ops.install``.
"""
from __future__ import annotations

import json

import numpy as _np

from .base import InferShapeFatal, MXNetError
from .attribute import AttrScope
from .name import NameManager

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "pow", "maximum", "minimum"]


class _Node:
    """One operator application (or a variable when op is None).
    Analog of StaticGraph::Node (ref: src/symbol/static_graph.h:32)."""

    __slots__ = ("op", "name", "params", "inputs", "attrs")

    def __init__(self, op, name, params, inputs, attrs=None):
        self.op = op          # OpDef or None for variables
        self.name = name
        self.params = params  # parsed param dict
        self.inputs = inputs  # list of (_Node, out_index)
        self.attrs = dict(attrs or {})

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        if self.is_variable:
            return 1
        return len(self.op.list_outputs(self.params))


def _topo_sort(head_nodes):
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for n in head_nodes:
        visit(n)
    return order


class Symbol:
    """Immutable handle to a list of output entries of a node DAG
    (ref: python/mxnet/symbol.py class Symbol)."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (_Node, out_idx)

    # -- introspection --------------------------------------------------------
    @property
    def nodes(self):
        return _topo_sort([n for n, _ in self._outputs])

    def list_arguments(self):
        """ref: symbol.py:371 — variable names in topo order."""
        return [n.name for n in self.nodes if n.is_variable and not n.attrs.get("__aux__")]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                onames = node.op.list_outputs(node.params)
                suffix = onames[idx]
                names.append("%s_%s" % (node.name, suffix))
        return names

    def list_auxiliary_states(self):
        """ref: symbol.py:399. Aux states are per-node (BatchNorm moving
        stats); we synthesize global names node_name + '_' + aux_name."""
        names = []
        for n in self.nodes:
            if n.is_variable:
                if n.attrs.get("__aux__"):
                    names.append(n.name)
                continue
            for aux in n.op.list_auxiliary_states(n.params):
                names.append("%s_%s" % (n.name, aux))
        return names

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def get_internals(self):
        """ref: symbol.py:500 — every node output as a head."""
        outs = []
        for n in self.nodes:
            for i in range(n.num_outputs()):
                outs.append((n, i))
        return Symbol(outs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %s not found in %s" % (index, names))
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    # -- attributes -----------------------------------------------------------
    def attr(self, key):
        node = self._outputs[0][0]
        return node.attrs.get(key)

    def list_attr(self, recursive=False):
        if not recursive:
            return dict(self._outputs[0][0].attrs)
        out = {}
        for n in self.nodes:
            for k, v in n.attrs.items():
                out["%s_%s" % (n.name, k)] = v
        return out

    def attr_dict(self):
        return {n.name: dict(n.attrs) for n in self.nodes if n.attrs}

    def _set_attr(self, **kwargs):
        for k, v in kwargs.items():
            self._outputs[0][0].attrs[k] = str(v)

    # -- composition ----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: substitute free variables with other symbols
        (ref: src/symbol/symbol.cc Compose; python symbol.py __call__ takes
        an optional name= which we accept for API parity)."""
        kwargs.pop("name", None)
        arg_names = self.list_arguments()
        mapping = {}
        if args:
            if len(args) > len(arg_names):
                raise MXNetError("too many positional args to compose")
            for name, s in zip(arg_names, args):
                mapping[name] = s
        for k, v in kwargs.items():
            if k in mapping:
                raise MXNetError("duplicate compose arg %s" % k)
            mapping[k] = v
        for k, v in mapping.items():
            if not isinstance(v, Symbol) or len(v._outputs) != 1:
                raise MXNetError("compose needs single-output Symbols")
        memo = {}

        def rebuild(node):
            if id(node) in memo:
                return memo[id(node)]
            if node.is_variable and node.name in mapping:
                new = mapping[node.name]._outputs[0][0]
            else:
                new = _Node(
                    node.op,
                    node.name,
                    node.params,
                    [(rebuild(n), i) for n, i in node.inputs],
                    node.attrs,
                )
            memo[id(node)] = new
            return new

        return Symbol([(rebuild(n), i) for n, i in self._outputs])

    # -- arithmetic sugar (ref: symbol.py __add__ etc.) ------------------------
    def _binop(self, other, opname, scalar_opname, rscalar_opname=None):
        from . import ops as _ops

        if isinstance(other, Symbol):
            return _create(opname, [self, other])
        if isinstance(other, (int, float)):
            return _create(scalar_opname, [self], scalar=float(other))
        raise TypeError("unsupported operand: %r" % (other,))

    def __add__(self, other):
        return self._binop(other, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        if isinstance(other, (int, float)):
            return _create("_rminus_scalar", [self], scalar=float(other))
        return NotImplemented

    def __mul__(self, other):
        return self._binop(other, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "_div", "_div_scalar")

    def __rtruediv__(self, other):
        if isinstance(other, (int, float)):
            return _create("_rdiv_scalar", [self], scalar=float(other))
        return NotImplemented

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar")

    def __neg__(self):
        return _create("_mul_scalar", [self], scalar=-1.0)

    def __copy__(self):
        return Symbol(list(self._outputs))

    # pickle via JSON (ref: python/mxnet/symbol.py __getstate__/__setstate__) —
    # needed so optimizers holding `sym` ship through kvstore.set_optimizer
    def __getstate__(self):
        return {"json": self.tojson()}

    def __setstate__(self, state):
        self._outputs = load_json(state["json"])._outputs

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # -- shape / type inference ------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """ref: python/mxnet/symbol.py:445; fixed-point like
        StaticGraph::InferShape (static_graph.h:262)."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, s in zip(arg_names, args):
                if s is not None:
                    known[name] = tuple(s)
        for k, v in kwargs.items():
            if k not in arg_names:
                raise MXNetError("infer_shape: unknown argument %s" % k)
            known[k] = tuple(v)

        nodes = self.nodes
        shapes = {}  # (id(node), out_idx) -> shape
        arg_shapes_map = {}
        aux_shapes_map = {}
        for n in nodes:
            if n.is_variable and n.name in known:
                shapes[(id(n), 0)] = known[n.name]
                arg_shapes_map[n.name] = known[n.name]

        changed = True
        while changed:
            changed = False
            for n in nodes:
                if n.is_variable:
                    continue
                in_shapes = [shapes.get((id(s), i)) for s, i in n.inputs]
                try:
                    ins, outs, auxs = n.op.infer_shape(n.params, in_shapes)
                except InferShapeFatal:
                    raise  # a proven-real failure, not "inputs not ready"
                except MXNetError:
                    continue
                for (src, i), s in zip(n.inputs, ins):
                    if s is not None and shapes.get((id(src), i)) != tuple(s):
                        shapes[(id(src), i)] = tuple(s)
                        changed = True
                        if src.is_variable:
                            arg_shapes_map[src.name] = tuple(s)
                for i, s in enumerate(outs):
                    if s is None:  # op could not resolve this output yet
                        continue
                    if shapes.get((id(n), i)) != tuple(s):
                        shapes[(id(n), i)] = tuple(s)
                        changed = True
                for an, s in zip(n.op.list_auxiliary_states(n.params), auxs):
                    if s is None:  # aux not derivable on this sweep
                        continue
                    aux_shapes_map["%s_%s" % (n.name, an)] = tuple(s)

        # user-provided shapes must agree with the fixed point — silent
        # override hides real bugs (ref: InferShape CHECK on provided args)
        for name, s in known.items():
            inferred = arg_shapes_map.get(name)
            if inferred is not None and tuple(inferred) != tuple(s):
                raise MXNetError(
                    "infer_shape: shape mismatch for %s: provided %s but "
                    "inferred %s" % (name, tuple(s), tuple(inferred)))

        arg_shapes = [arg_shapes_map.get(nm) for nm in arg_names]
        out_shapes = [shapes.get((id(nd), i)) for nd, i in self._outputs]
        aux_shapes = [aux_shapes_map.get(nm) for nm in self.list_auxiliary_states()]
        if not partial and (any(s is None for s in arg_shapes) or any(s is None for s in out_shapes)):
            if all(s is None for s in out_shapes) and not known:
                return None, None, None
            missing = [nm for nm, s in zip(arg_names, arg_shapes) if s is None]
            raise MXNetError("infer_shape: cannot determine shapes for %s" % missing)
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """ref: python/mxnet/symbol.py:404."""
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, t in zip(arg_names, args):
                if t is not None:
                    known[name] = _np.dtype(t)
        for k, v in kwargs.items():
            known[k] = _np.dtype(v)
        nodes = self.nodes
        types = {}
        arg_types_map = {}
        aux_types_map = {}
        for n in nodes:
            if n.is_variable and n.name in known:
                types[(id(n), 0)] = known[n.name]
                arg_types_map[n.name] = known[n.name]
        for _ in range(3):
            for n in nodes:
                if n.is_variable:
                    continue
                in_types = [types.get((id(s), i)) for s, i in n.inputs]
                try:
                    ins, outs, auxs = n.op.infer_type(n.params, in_types)
                except MXNetError:
                    continue
                for (src, i), t in zip(n.inputs, ins):
                    if t is not None:
                        types[(id(src), i)] = t
                        if src.is_variable:
                            arg_types_map[src.name] = t
                for i, t in enumerate(outs):
                    types[(id(n), i)] = t
                for an, t in zip(n.op.list_auxiliary_states(n.params), auxs):
                    aux_types_map["%s_%s" % (n.name, an)] = t
        arg_types = [arg_types_map.get(nm, _np.dtype("float32")) for nm in arg_names]
        out_types = [types.get((id(nd), i), _np.dtype("float32")) for nd, i in self._outputs]
        aux_types = [aux_types_map.get(nm, _np.dtype("float32")) for nm in self.list_auxiliary_states()]
        return arg_types, out_types, aux_types

    # -- binding ---------------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None, group2ctx=None,
                    shared_exec=None, **kwargs):
        """ref: python/mxnet/symbol.py:635."""
        from .executor import Executor

        return Executor._simple_bind(
            self, ctx, grad_req=grad_req, type_dict=type_dict,
            group2ctx=group2ctx, shared_exec=shared_exec, **kwargs
        )

    def bind(self, ctx, args, args_grad=None, grad_req="write", aux_states=None,
             group2ctx=None, shared_exec=None, _compile_opts=None):
        """ref: python/mxnet/symbol.py:716 / MXExecutorBindEX (c_api.h:973).
        ``_compile_opts`` (internal) forwards options to the compile
        layer's graph rewrite — the Predictor passes its frozen
        parameters here so constant folding may bake them
        (compile/fold.py)."""
        from .executor import Executor

        return Executor(
            self, ctx, args, args_grad=args_grad, grad_req=grad_req,
            aux_states=aux_states, group2ctx=group2ctx, shared_exec=shared_exec,
            _compile_opts=_compile_opts
        )

    def grad(self, wrt):
        """ref: python/mxnet/symbol.py:851 — kept for API parity; gradients
        are produced by Executor.backward (torch.autograd)."""
        raise MXNetError("Symbol.grad is superseded by Executor.backward in this framework")

    # -- compilation -----------------------------------------------------------
    def optimize(self, input_shapes=None, input_types=None,
                 frozen_params=None):
        """Run the compile-layer rewrite passes over this DAG and return
        the rewritten Symbol (``self`` when nothing applies or the
        layer is disabled). The result shares variable nodes with this
        graph and contains executor-internal ops — bind it, don't
        serialize it. See ``MXNET_COMPILE_OPT`` (``compile/``)."""
        from . import compile as _compile

        return _compile.optimize(self, input_shapes=input_shapes,
                                 input_types=input_types,
                                 frozen_params=frozen_params)

    # -- serialization ---------------------------------------------------------
    def tojson(self):
        """ref: symbolic.h:227 Symbol JSON; format mirrors the reference's
        {nodes, arg_nodes, heads}."""
        nodes = self.nodes
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "param": {k: str(v) for k, v in (n.params or {}).items() if v is not None},
                "inputs": [[nid[id(s)], i] for s, i in n.inputs],
                "attr": {k: str(v) for k, v in n.attrs.items()},
            })
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "heads": [[nid[id(nd)], i] for nd, i in self._outputs],
        }, indent=2)

    def save(self, fname):
        from .stream import open_stream

        with open_stream(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self):
        lines = []
        for n in self.nodes:
            kind = "Variable" if n.is_variable else n.op.name
            ins = ", ".join("%s[%d]" % (s.name, i) for s, i in n.inputs)
            lines.append("%s %s(%s)" % (kind, n.name, ins))
        return "\n".join(lines)


# -- constructors --------------------------------------------------------------

def Variable(name, attr=None, shape=None, **kwargs):
    """ref: python/mxnet/symbol.py:920."""
    attrs = AttrScope.current.get(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    for k, v in kwargs.items():
        attrs["__%s__" % k] = str(v)
    node = _Node(None, name, {}, [], attrs)
    return Symbol([(node, 0)])


def Group(symbols):
    """ref: python/mxnet/symbol.py:940."""
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def _create(op_name, input_syms, name=None, attr=None, **kwargs):
    """Create an op node from input Symbols + params; the analog of the
    generated atomic-symbol functions (ref: symbol.py:991)."""
    from .ops import registry as _registry

    op = _registry.get(op_name)
    params = op.parse_params(kwargs)
    attrs = AttrScope.current.get(attr)
    name = NameManager.current.get(name, op.name.lower().lstrip("_"))
    inputs = []
    for s in input_syms:
        if not isinstance(s, Symbol):
            raise MXNetError("op %s: inputs must be Symbols, got %r" % (op_name, s))
        if len(s._outputs) != 1:
            raise MXNetError("op %s: cannot take grouped symbol as input" % op_name)
        inputs.append(s._outputs[0])
    node = _Node(op, name, params, inputs, attrs)
    nout = node.num_outputs()
    return Symbol([(node, i) for i in range(nout)]) if nout > 1 else Symbol([(node, 0)])


def _make_op_func(op, func_name):
    """Build a mx.sym.<Op>(...) constructor for a registered OpDef.

    Naming follows the reference convention: the node name resolves first
    (user-given or NameManager hint), then missing inputs are auto-created
    as Variables named `{node_name}_{arg_name}` — so
    FullyConnected(name='fc1') yields 'fc1_weight'/'fc1_bias' and
    SoftmaxOutput(name='softmax') yields 'softmax_label', matching the
    data-iterator default label name (ref: symbol.py:991 generated
    functions + ListArguments-driven variable creation)."""

    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_args = list(args)
        sym_kwargs = {}
        param_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                param_kwargs[k] = v
        if op.key_var_num_args and op.key_var_num_args not in param_kwargs and sym_args:
            param_kwargs[op.key_var_num_args] = len(sym_args)
        if "__kwargs__" in op.param_fields:
            # Custom-style ops forward arbitrary string kwargs to the
            # user Prop constructor (ref: operator.py:533 register /
            # c_api.h:1418 MXCustomOpRegister kwargs-as-strings)
            extra = {}
            for k in list(param_kwargs):
                if k not in op.param_fields:
                    extra[k] = param_kwargs.pop(k)
            if extra:
                kw = dict(param_kwargs.get("__kwargs__") or {})
                kw.update({k: str(v) for k, v in extra.items()})
                param_kwargs["__kwargs__"] = kw
        params = op.parse_params(param_kwargs)
        arg_names = op.list_arguments(params)
        name = NameManager.current.get(name, op.name.lower().lstrip("_"))
        inputs = [None] * len(arg_names)
        if len(sym_args) > len(arg_names):
            raise MXNetError(
                "op %s: too many inputs (%d given, %d expected)"
                % (op.name, len(sym_args), len(arg_names))
            )
        for i, s in enumerate(sym_args):
            if not isinstance(s, Symbol):
                raise MXNetError("op %s: inputs must be Symbols" % op.name)
            inputs[i] = s
        for k, v in sym_kwargs.items():
            if k not in arg_names:
                raise MXNetError("op %s: unknown input %s (inputs: %s)" % (op.name, k, arg_names))
            if inputs[arg_names.index(k)] is not None:
                raise MXNetError("op %s: input %s given twice" % (op.name, k))
            inputs[arg_names.index(k)] = v
        for i, an in enumerate(arg_names):
            if inputs[i] is None:
                inputs[i] = Variable("%s_%s" % (name, an))
        attrs = AttrScope.current.get(attr)
        entries = []
        for s in inputs:
            if len(s._outputs) != 1:
                raise MXNetError("op %s: cannot take grouped symbol as input" % op.name)
            entries.append(s._outputs[0])
        node = _Node(op, name, params, entries, attrs)
        nout = node.num_outputs()
        return Symbol([(node, i) for i in range(nout)]) if nout > 1 else Symbol([(node, 0)])

    creator.__name__ = func_name
    from .ops.opdoc import build_doc

    creator.__doc__ = build_doc(op, func_name, kind="symbol")
    return creator


# -- JSON load -----------------------------------------------------------------

def load_json(json_str):
    """ref: python/mxnet/symbol.py:976 / MXSymbolCreateFromJSON (c_api.h:560)."""
    from .ops import registry as _registry

    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        if jn["op"] == "null":
            node = _Node(None, jn["name"], {}, [], jn.get("attr", {}))
        else:
            op = _registry.get(jn["op"])
            params = op.parse_params(jn.get("param", {}))
            inputs = [(nodes[i], idx) for i, idx in jn["inputs"]]
            node = _Node(op, jn["name"], params, inputs, jn.get("attr", {}))
        nodes.append(node)
    return Symbol([(nodes[i], idx) for i, idx in data["heads"]])


def load(fname):
    """Load a Symbol from a JSON file or stream URI."""
    from .stream import open_stream

    with open_stream(fname, "r") as f:
        return load_json(f.read())


def pow(base, exp):
    """ref: python/mxnet/symbol.py pow."""
    if isinstance(base, Symbol) and isinstance(exp, Symbol):
        return _create("_power", [base, exp])
    if isinstance(base, Symbol):
        return base ** exp
    if isinstance(exp, Symbol):
        return _create("_rpower_scalar", [exp], scalar=float(base))
    return base ** exp


def maximum(lhs, rhs):
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _create("_maximum", [lhs, rhs])
    if isinstance(lhs, Symbol):
        return _create("_maximum_scalar", [lhs], scalar=float(rhs))
    if isinstance(rhs, Symbol):
        return _create("_maximum_scalar", [rhs], scalar=float(lhs))
    # not max(): ops.install attaches the 'max' reduction to this module
    return lhs if lhs > rhs else rhs


def minimum(lhs, rhs):
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _create("_minimum", [lhs, rhs])
    if isinstance(lhs, Symbol):
        return _create("_minimum_scalar", [lhs], scalar=float(rhs))
    if isinstance(rhs, Symbol):
        return _create("_minimum_scalar", [rhs], scalar=float(lhs))
    return lhs if lhs < rhs else rhs   # see maximum(): 'min' is an op here
