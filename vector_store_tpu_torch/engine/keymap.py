"""PrimaryKey ⇄ slot bimap.

The reference keeps a `bimap<PrimaryKey, u64>` beside the usearch index
with an atomic key allocator and a rollback dance on racy duplicate
inserts (src/index/usearch.rs:109-113,181-196,214-232).  Here slot
allocation lives in the device index (sequential rows), so the map just
tracks key→slot and slot→key; the owning actor serialises mutation.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..types import PrimaryKey


class KeyMap:
    def __init__(self) -> None:
        self._by_key: dict[PrimaryKey, int] = {}
        self._by_slot: dict[int, PrimaryKey] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: PrimaryKey) -> bool:
        return key in self._by_key

    def slot_of(self, key: PrimaryKey) -> Optional[int]:
        return self._by_key.get(key)

    def key_of(self, slot: int) -> Optional[PrimaryKey]:
        return self._by_slot.get(slot)

    def bind(self, key: PrimaryKey, slot: int) -> Optional[int]:
        """Bind key→slot; returns the displaced old slot if the key existed
        (caller tombstones it — the add_or_replace dance,
        usearch.rs:214-232)."""
        old = self._by_key.get(key)
        if old is not None:
            del self._by_slot[old]
        self._by_key[key] = slot
        self._by_slot[slot] = key
        return old

    def unbind(self, key: PrimaryKey) -> Optional[int]:
        """Remove a key; returns its slot (to tombstone) or None."""
        slot = self._by_key.pop(key, None)
        if slot is not None:
            del self._by_slot[slot]
        return slot

    def keys(self) -> Iterator[PrimaryKey]:
        return iter(self._by_key)
