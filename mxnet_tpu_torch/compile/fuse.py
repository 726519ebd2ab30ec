"""Op-fusion pass: collapse elementwise chains into single fused nodes.

Counterpart of ``mxnet_tpu/compile/fuse.py``. What it removes in the
port is what the executor pays *per node* beside the kernels: one
``op.apply`` and its env bookkeeping per node in ``Executor._run``, one
entry per node in the mirror planner's segments (it segments whatever
nodes it is given — fewer nodes, coarser segments), and one entry per
node in every graph walk after this one. A ResNet-style shortcut tail
(``add -> relu``) or a hand-built normalization chain of 5 scalar ops
becomes ONE node whose forward applies the composed closure (conv and
BatchNorm themselves stay out — see the envelope below). The members
still launch one kernel each: a fused chain through one generated
kernel is later work.

The chain discovery lives in ``ir.find_fusible_chains`` (a byte copy of
the JAX package's), so the port fuses exactly the chains the JAX
package does.

Correctness envelope: only ops with the default elementwise shape
contract, one output, no aux, no RNG, no host kernel and no loss-head
semantics enter a chain (``ir.is_elementwise``), and interior values
must have exactly one consumer and not be graph heads. The fused forward
applies the member ops in original topological order — the same torch
calls in the same order, so outputs are bit-identical to the graph
without the pass, and gradients come from autograd through the
composed closure.
"""
from __future__ import annotations

from . import ir

__all__ = ["apply", "make_fused_op", "FUSED_OP_PREFIX"]

FUSED_OP_PREFIX = "_mxc_fused"


def make_fused_op(chain, ext_keys_per_node):
    """Build a one-off OpDef whose forward runs ``chain`` composed.

    ``ext_keys_per_node``: for each chain node, the list of input slots
    ``(pos_in_node_inputs, ext_index_or_None)`` — None marks the slot
    fed by the previous chain node's output. The OpDef is NOT put in
    the registry (the rewritten graph is an executor-internal artifact,
    never serialized; the user's symbol is untouched)."""
    from ..ops.registry import OpDef

    ops = [(n.op, dict(n.params or {})) for n in chain]
    slot_plans = list(ext_keys_per_node)

    def forward(params, inputs, aux, is_train, rng):
        cur = None
        for (op, p), slots in zip(ops, slot_plans):
            ins = [cur if ext is None else inputs[ext]
                   for _pos, ext in slots]
            outs, _aux = op.apply(p, ins, [], is_train, None)
            cur = outs[0]
        return [cur], []

    n_ext = 1 + max(
        (ext for slots in slot_plans for _p, ext in slots
         if ext is not None), default=-1)
    return OpDef(
        FUSED_OP_PREFIX + "[%s]" % "+".join(op.name for op, _ in ops),
        forward,
        arguments=tuple("in%d" % i for i in range(n_ext)),
        doc="compile-time fused elementwise chain (compile/fuse.py)",
    )


def apply(sym, input_shapes=None, tuner=None):
    """Rewrite ``sym``: every fusible chain becomes one fused node.

    ``tuner``: optional autotuner (compile/autotune.py). When present,
    each chain's segment boundary is a measured choice — the chain is
    fused whole or split at the tuned boundary — keyed by the chain's
    op signature and shape. Without a tuner, chains fuse whole.

    Returns ``(new_sym, n_chains_fused)``; ``new_sym is sym`` when
    nothing fused.
    """
    chains = ir.find_fusible_chains(sym)
    if tuner is not None and input_shapes:
        chains = _split_tuned(sym, chains, input_shapes, tuner)
    if not chains:
        return sym, 0

    last_of_chain = {}   # id(last node) -> chain
    interior = set()
    for chain in chains:
        last_of_chain[id(chain[-1])] = chain
        interior.update(id(n) for n in chain[:-1])

    def replace(node, new_inputs, memo):
        chain = last_of_chain.get(id(node))
        if chain is None:
            return None  # interior nodes clone through and go dead
        chain_ids = {id(n) for n in chain}
        ext_entries, ext_index = [], {}
        slot_plans = []
        for ci, n in enumerate(chain):
            slots = []
            for pos, (src, oidx) in enumerate(n.inputs):
                if ci > 0 and id(src) in chain_ids and oidx == 0 \
                        and src is chain[ci - 1]:
                    slots.append((pos, None))
                    continue
                key = (id(src), oidx)
                if key not in ext_index:
                    ext_index[key] = len(ext_entries)
                    ext_entries.append((memo[id(src)], oidx))
                slots.append((pos, ext_index[key]))
            slot_plans.append(slots)
        op = make_fused_op(chain, slot_plans)
        from ..symbol import _Node

        fused = _Node(op, chain[-1].name, {}, ext_entries,
                      {"__mxc_opt__": "fuse",
                       "__mxc_members__": ",".join(n.name for n in chain)})
        return fused

    new_sym = ir.rebuild(sym, replace)
    return new_sym, len(chains)


def _split_tuned(sym, chains, input_shapes, tuner):
    """Consult the autotuner for each chain's segment boundary.

    The contested choice: fuse the whole chain into one segment, or
    split it in half (two fused segments — the boundary re-exposes one
    intermediate to the planner). Measured once per (op signature,
    shape, dtype, backend) and persisted in the tuning DB."""
    seed = {}
    nodes = sym.nodes
    for n in nodes:
        if n.is_variable and input_shapes and n.name in input_shapes:
            seed[(id(n), 0)] = tuple(input_shapes[n.name])
    shapes = ir.propagate_shapes(nodes, seed) if seed else {}
    out = []
    for chain in chains:
        shape = shapes.get((id(chain[0]), 0))
        if shape is None or len(chain) < 4:
            out.append(chain)  # nothing to contest below 2+2
            continue
        choice = tuner.pick_segment_boundary(
            [n.op.name for n in chain], shape)
        if choice == "split":
            mid = len(chain) // 2
            for part in (chain[:mid], chain[mid:]):
                if len(part) >= 2:
                    out.append(part)
        else:
            out.append(chain)
    return out
