"""The warm re-fit state's records: a value kept across fits under a key,
as in the JAX package, and values kept one a device."""
from __future__ import annotations

from functools import cached_property


class Kept:
    """One value kept under the key it was built for: the objects ``objs``,
    compared by identity (an id alone can be recycled), and the values
    ``vals``, compared by ``==``; ``value`` is None when none is kept."""

    def __init__(self):
        self.drop()

    def get(self, objs: tuple, vals: tuple, build):
        """``(value, hit)``: the kept value if its key is ``objs`` and
        ``vals``; else the old value is dropped, then ``build()``'s kept."""
        if self.objs is not None \
                and all(a is b for a, b in zip(objs, self.objs)) \
                and vals == self.vals:
            return self.value, True
        self.drop()
        self.value = build()
        self.objs, self.vals = objs, vals
        return self.value, False

    def drop(self):
        """Keep nothing: the value and its key's objects are released."""
        self.objs = self.vals = self.value = None

    @classmethod
    def slot(cls):
        """A class attribute giving each instance its own ``Kept``."""
        return cached_property(lambda self: cls())


class PerDevice(dict):
    """Values kept one a device, each made on the first ask for it."""

    def on(self, device, make):
        """The value kept for ``device``, else ``make()``'s, kept."""
        if device not in self:
            self[device] = make()
        return self[device]
