"""AttrScope: scoped symbol attributes (ref: python/mxnet/attribute.py:1-61).

This is how the reference tags subgraphs for model parallelism:
``with mx.AttrScope(ctx_group='layer0'): ...`` attaches ctx_group attrs that
bind-time ``group2ctx`` maps to devices (SURVEY §2.7 model parallelism;
ref: example/model-parallel-lstm/lstm.py:48-99). On TPU the executor maps
ctx_group to device placement / sharding annotations.
"""
from __future__ import annotations


class AttrScope:
    current = None

    def __init__(self, **kwargs):
        self._old_scope = None
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs

    def get(self, attr):
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current
        attr = AttrScope.current._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope.current = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_scope is not None
        AttrScope.current = self._old_scope


AttrScope.current = AttrScope()
