"""Values derived from parameter tensors, kept once per version of them.

The kernels read their weights in forms of their own (quantized, padded,
split). `derived` keeps those forms until the parameters change: an entry
is keyed on the first parameter's identity and stamped with every
parameter's `data_ptr()` and `_version`, so an in-place update (an
optimizer step, `load_state_dict`, `copy_` under no_grad) gives the next
call a new, empty entry. It holds the parameters by weak reference only,
and goes when the first of them is freed.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Sequence

import torch


def _stamps(params):
    return tuple((t.data_ptr(), t._version) for t in params)


class Entry:
    """Weak references to one version of the parameters, their stamps, and
    the values derived from them (keys chosen by the caller)."""

    __slots__ = ("refs", "stamps", "values")

    def __init__(self, params):
        self.refs = tuple(weakref.ref(t) for t in params)
        self.stamps = _stamps(params)
        self.values: Dict[Any, Any] = {}

    def matches(self, params) -> bool:
        return all(r() is t for r, t in zip(self.refs, params)) and self.stamps == _stamps(params)


def derived(cache: Dict[int, Entry], params: Sequence[torch.Tensor]) -> Dict[Any, Any]:
    """The dict of values derived from this version of `params`, kept in
    `cache` (id(params[0]) -> Entry): the entry's, or a new empty one."""
    key = id(params[0])
    entry = cache.get(key)
    if entry is None or not entry.matches(params):
        if entry is None:  # first entry of this parameter: drop it when it is freed
            weakref.finalize(params[0], cache.pop, key, None)
        entry = cache[key] = Entry(params)
    return entry.values
