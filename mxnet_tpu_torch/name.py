"""NameManager: automatic symbol naming (ref: python/mxnet/name.py:1-78)."""
from __future__ import annotations


class NameManager:
    current = None

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = NameManager.current
        NameManager.current = self
        return self

    def __exit__(self, ptype, value, trace):
        assert self._old_manager is not None
        NameManager.current = self._old_manager


class Prefix(NameManager):
    """ref: python/mxnet/name.py:60 — prepends a prefix to all names."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


NameManager.current = NameManager()
