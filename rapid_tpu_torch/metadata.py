"""Per-node application metadata registry.

The port's own copy of ``rapid_tpu/metadata.py``.

Reference: MetadataManager.java:38-69 -- immutable key->bytes tags per node,
shipped to joiners in JoinResponses; put-if-absent semantics.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

from .types import Endpoint

FrozenMetadata = Tuple[Tuple[str, bytes], ...]


class MetadataManager:
    def __init__(self) -> None:
        self._table: Dict[Endpoint, FrozenMetadata] = {}  # guarded-by: protocol-executor

    def get(self, node: Endpoint) -> FrozenMetadata:
        return self._table.get(node, ())

    def add_metadata(self, roles: Mapping[Endpoint, FrozenMetadata]) -> None:
        """put-if-absent per node (MetadataManager.java:47-55)."""
        for node, metadata in roles.items():
            self._table.setdefault(node, metadata)

    def remove_node(self, node: Endpoint) -> None:
        self._table.pop(node, None)

    def get_all_metadata(self) -> Dict[Endpoint, FrozenMetadata]:
        return dict(self._table)
