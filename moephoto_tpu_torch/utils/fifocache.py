"""Bounded FIFO result cache with an eviction callback.

The server's session-note and result cache: the oldest entry is evicted
when capacity is reached, missing keys return a default, and dict
values merge on update.
"""

from collections import OrderedDict


class Cache:
    def __init__(self, size, default=None, onExtinct=None):
        self._data: OrderedDict = OrderedDict()
        self._capacity = size
        self.default = default
        self._onEvict = onExtinct

    def put(self, key, item):
        if key in self._data:
            # refresh insertion order like a queue re-append would
            self._data.move_to_end(key)
            self._data[key] = item
            return
        while len(self._data) >= self._capacity:
            oldKey, oldItem = self._data.popitem(last=False)
            if self._onEvict:
                self._onEvict(oldKey, oldItem)
        self._data[key] = item

    def pop(self, key):
        return self._data.pop(key, self.default)

    def update(self, key, item):
        existing = self._data.get(key)
        if isinstance(existing, dict) and isinstance(item, dict):
            existing.update(item)
            item = existing
        self.put(key, item)

    def peek(self, key):
        return key in self._data
