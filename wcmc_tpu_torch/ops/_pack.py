"""A cache of parameters packed into the layout a hand kernel reads.

A kernel wrapper packs its weights once per parameter value, not once per
call: :class:`PackCache` keys each entry on every packed tensor's data
pointer, version counter (bumped by every in-place update, so an optimizer
step misses), shape, strides, dtype and device, with the packing's own
arguments, and drops the least recently used entry past its size.
"""

from __future__ import annotations

import collections


class PackCache:
    """``get(tensors, extra, pack)`` returns ``pack(*tensors)``, made once
    per value of ``tensors`` and of ``extra``.  An entry holds the tensors
    themselves, so their memory cannot be freed and reused by others that
    would match the key while the entry lives.  Tensors made in inference
    mode have no version counter and are packed on every call.  ``hits``
    and ``misses`` count the calls that found an entry and those that
    packed, since the cache was made or cleared."""

    def __init__(self, size: int):
        self.size = size
        self.hits = self.misses = 0
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def __len__(self):
        return len(self._entries)

    def clear(self):
        self._entries.clear()
        self.hits = self.misses = 0

    def get(self, tensors, extra, pack):
        tensors = tuple(tensors)
        if any(t.is_inference() for t in tensors):
            self.misses += 1
            return pack(*tensors)
        key = (extra, *((t.data_ptr(), t._version, tuple(t.shape), t.stride(), t.dtype,
                         t.device) for t in tensors))
        hit = self._entries.get(key)
        if hit is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return hit[1]
        self.misses += 1
        packed = pack(*(t.detach() for t in tensors))
        self._entries[key] = (tensors, packed)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return packed
