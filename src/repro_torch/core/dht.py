"""Distributed Hash Table (paper §3.4, §3.9): decentralized key-value
storage for datasets, activations and checkpoints.

Consistent hashing ring with virtual nodes + replication.  This is a
faithful single-process simulation of the paper's DHT layer: each
compnode hosts a shard of the ring; lookups route by key hash; node
failures lose only the shards whose every replica died.

A copy of ``repro.core.dht``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Any, Dict, List, Optional, Sequence


def _h(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class DHT:
    def __init__(self, node_ids: Sequence[int], *, virtual: int = 32,
                 replication: int = 2):
        self.virtual = virtual
        self.replication = replication
        self._ring: List[tuple] = []              # (hash, node_id)
        self._stores: Dict[int, Dict[str, Any]] = {}
        for nid in node_ids:
            self.join(nid)

    # -- membership ---------------------------------------------------------
    def join(self, node_id: int) -> None:
        if node_id in self._stores:
            return
        self._stores[node_id] = {}
        for v in range(self.virtual):
            bisect.insort(self._ring, (_h(f"n{node_id}#{v}"), node_id))

    def leave(self, node_id: int) -> None:
        """Node failure: its store vanishes; ring entries removed."""
        self._stores.pop(node_id, None)
        self._ring = [(h, n) for h, n in self._ring if n != node_id]

    @property
    def nodes(self) -> List[int]:
        return list(self._stores)

    # -- routing --------------------------------------------------------------
    def owners(self, key: str) -> List[int]:
        """First ``replication`` distinct nodes clockwise from hash(key)."""
        if not self._ring:
            return []
        i = bisect.bisect_left(self._ring, (_h(key), -1)) % len(self._ring)
        seen: List[int] = []
        j = i
        while len(seen) < min(self.replication, len(self._stores)):
            nid = self._ring[j % len(self._ring)][1]
            if nid not in seen:
                seen.append(nid)
            j += 1
        return seen

    # -- data plane -------------------------------------------------------------
    def put(self, key: str, value: Any) -> List[int]:
        owners = self.owners(key)
        for nid in owners:
            self._stores[nid][key] = value
        return owners

    def get(self, key: str) -> Optional[Any]:
        for nid in self.owners(key):
            if key in self._stores.get(nid, {}):
                return self._stores[nid][key]
        # replicas may have moved after churn: fall back to a full scan
        for store in self._stores.values():
            if key in store:
                return store[key]
        return None

    def rebalance(self, key_iter: Optional[Sequence[str]] = None) -> int:
        """Re-replicate keys whose owner set changed after churn; returns
        number of copies made."""
        copies = 0
        all_keys = set()
        for store in self._stores.values():
            all_keys.update(store)
        for key in (key_iter or sorted(all_keys)):
            val = self.get(key)
            if val is None:
                continue
            for nid in self.owners(key):
                if key not in self._stores[nid]:
                    self._stores[nid][key] = val
                    copies += 1
        return copies
