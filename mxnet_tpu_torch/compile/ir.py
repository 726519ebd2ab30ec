"""Shared Symbol-graph IR walk utilities.

The compile passes (fuse/layout/fold), the executor's segment planner and
the mxlint graph pass all need the same handful of graph facts: consumer
maps, head keys, best-effort shape propagation, elementwise-op
classification and fusible-chain discovery. This module is the one place
those walks live — ``analysis/graph_lint.py`` imports it for the
``fusible-chain`` finding and its shape sweep, and the rewrite passes in
this package build on it for their pattern matching.

Deliberately jax-free: everything here is host-side metadata walking
(the graph lint must stay importable before any device is touched, see
analysis/graph_lint.py). Rewrites that *evaluate* ops (constant folding)
import jax inside the pass module, not here.

Node duck type: ``analysis`` consumes ``symbol._Node`` objects —
``op`` (OpDef or None), ``name``, ``params``, ``inputs``
(list of ``(node, out_idx)``), ``attrs``.
"""
from __future__ import annotations

__all__ = [
    "head_keys", "consumers_map", "propagate_shapes", "propagate_dtypes",
    "is_elementwise", "find_fusible_chains", "rebuild",
]


def head_keys(sym):
    """The set of ``(id(node), out_idx)`` entries that are graph heads."""
    return {(id(n), i) for n, i in sym._outputs}


def consumers_map(nodes):
    """Map ``(id(src), out_idx)`` -> set of consumer serials (indices
    into ``nodes``). The executor's segment planner and the fusion
    pass both key liveness off this."""
    consumers = {}
    for serial, n in enumerate(nodes):
        if n.is_variable:
            continue
        for s, i in n.inputs:
            consumers.setdefault((id(s), i), set()).add(serial)
    return consumers


def propagate_shapes(nodes, seed, sweeps=3):
    """Best-effort forward/backward shape sweep over the DAG.

    ``seed`` maps ``(id(node), out_idx)`` -> shape. Unknown stays
    absent; op infer errors are skipped (callers must tolerate a
    partially-specified graph — the lint and the layout pass both run
    on whatever shapes are recoverable)."""
    shapes = dict(seed)
    for _ in range(sweeps):  # bidirectional infer needs a couple of sweeps
        changed = False
        for n in nodes:
            if n.is_variable:
                continue
            in_shapes = [shapes.get((id(s), i)) for s, i in n.inputs]
            try:
                ins, outs, _aux = n.op.infer_shape(n.params, in_shapes)
            except Exception:
                continue
            for (src, i), s in zip(n.inputs, ins):
                if s is not None and shapes.get((id(src), i)) != tuple(s):
                    shapes[(id(src), i)] = tuple(s)
                    changed = True
            for i, s in enumerate(outs):
                if s is not None and shapes.get((id(n), i)) != tuple(s):
                    shapes[(id(n), i)] = tuple(s)
                    changed = True
        if not changed:
            break
    return shapes


def propagate_dtypes(nodes, seed, sweeps=3):
    """Best-effort dtype sweep (the type analog of propagate_shapes).
    ``seed`` maps ``(id(node), out_idx)`` -> numpy dtype. The autotuner
    keys its decisions by the dtype an op ACTUALLY computes in, which
    for every layer past the first is an interior edge — only a
    propagation from the bound-argument dtypes can answer that."""
    dtypes = dict(seed)
    for _ in range(sweeps):
        changed = False
        for n in nodes:
            if n.is_variable:
                continue
            in_types = [dtypes.get((id(s), i)) for s, i in n.inputs]
            try:
                _ins, outs, _aux = n.op.infer_type(n.params, in_types)
            except Exception:
                continue
            for i, t in enumerate(outs):
                if t is not None and dtypes.get((id(n), i)) != t:
                    dtypes[(id(n), i)] = t
                    changed = True
        if not changed:
            break
    return dtypes


def is_elementwise(node):
    """True iff ``node`` is a plain elementwise op the fusion pass may
    place inside a fused segment: default (elementwise) shape
    inference, one output, no aux state, no RNG, no host kernel, no
    loss-head semantics. The default-infer_shape test is the load-
    bearing one — every op registered without a custom ``infer_shape``
    promises all inputs and outputs share one shape (registry.py)."""
    if node.is_variable:
        return False
    op = node.op
    if getattr(op, "_infer_shape", None) is not None:
        return False
    if op.is_host_op or op.need_rng:
        return False
    if op.head_no_grad(node.params):
        return False
    if len(op.list_outputs(node.params)) != 1:
        return False
    if op.list_auxiliary_states(node.params):
        return False
    return True


def find_fusible_chains(sym, min_len=2):
    """Maximal linear chains of elementwise ops.

    A chain is a node sequence ``n1 -> n2 -> ... -> nk`` where every
    node ``is_elementwise``, each interior link is the ONLY consumer of
    its producer's output, and no interior output is a graph head
    (interior values must be free to disappear into the fused
    segment). Non-chain inputs of interior nodes (the other operand of
    a binary op) become external inputs of the fused segment.

    Returns a list of chains, each a list of nodes in topo order.
    Shared by the fusion pass (which rewrites them) and the graph lint
    (which reports them as ``fusible-chain`` opportunities)."""
    nodes = sym.nodes
    cons = consumers_map(nodes)
    heads = head_keys(sym)

    def sole_consumer(n):
        """The unique elementwise consumer of n's single output, when
        the output is not a head and feeds exactly one input slot."""
        k = (id(n), 0)
        if k in heads:
            return None
        c = cons.get(k, set())
        if len(c) != 1:
            return None
        nxt = nodes[next(iter(c))]
        if not is_elementwise(nxt):
            return None
        # the producer must feed exactly one input slot of the consumer
        # (x * x would otherwise drop one operand in the rewrite)
        if sum(1 for s, i in nxt.inputs if s is n and i == 0) != 1:
            return None
        return nxt

    chains, in_chain = [], set()
    for n in nodes:
        if id(n) in in_chain or not is_elementwise(n):
            continue
        # only start a chain at a node whose producer link does NOT
        # continue a chain (maximality)
        chain = [n]
        cur = n
        while True:
            nxt = sole_consumer(cur)
            if nxt is None or id(nxt) in in_chain:
                break
            chain.append(nxt)
            cur = nxt
        if len(chain) >= min_len:
            chains.append(chain)
            in_chain.update(id(c) for c in chain)
    # chains come out in topo order of their first node: seeds walk the
    # topo list, and a seed that would continue an earlier chain was
    # already consumed by that chain's sole_consumer walk
    return chains


def rebuild(sym, replace):
    """Clone the graph under a node-level rewrite.

    ``replace(node, new_inputs, memo)`` returns either a replacement
    node or None to keep the node (with its inputs rewired to the
    cloned producers). ``memo`` maps ``id(original)`` -> clone for
    every already-lowered node, so a pass replacing a multi-node
    pattern can reach the clones of non-immediate producers (the
    fusion pass needs the external inputs of interior chain nodes).
    Variables are NEVER cloned — the executor maps bound arrays to
    variable nodes by identity, so passes must preserve variable
    objects. Returns a new Symbol over the rewritten heads.

    The walk is iterative (explicit stack): model-zoo graphs (unrolled
    RNNs) exceed Python's default recursion depth.
    """
    from ..symbol import Symbol

    memo = {}

    def lower(node):
        stack = [node]
        while stack:
            cur = stack[-1]
            if id(cur) in memo:
                stack.pop()
                continue
            pending = [s for s, _ in cur.inputs if id(s) not in memo]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            if cur.is_variable:
                memo[id(cur)] = cur
                continue
            new_inputs = [(memo[id(s)], i) for s, i in cur.inputs]
            out = replace(cur, new_inputs, memo)
            if out is None:
                if all(a is b for (a, _), (b, _) in zip(new_inputs, cur.inputs)):
                    out = cur  # untouched subtree: share, don't clone
                else:
                    from ..symbol import _Node

                    out = _Node(cur.op, cur.name, cur.params, new_inputs,
                                cur.attrs)
            memo[id(cur)] = out
        return memo[id(node)]

    return Symbol([(lower(n), i) for n, i in sym._outputs])
