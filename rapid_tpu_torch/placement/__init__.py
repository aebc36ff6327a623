"""Placement plane: deterministic weighted shard maps over the membership.

``engine`` is the object model (pure Python); ``device`` is the vectorized
mirror over the simulator's slot universe, whose top-R runs in the
hand-written CUDA kernel ``placement_topr`` (``csrc/placement_topr.cu``).
"""

from .engine import (
    DEFAULT_WEIGHT_KEY,
    MAX_WEIGHT,
    PlacementConfig,
    PlacementDiff,
    PlacementEngine,
    PlacementMap,
    PlacementSubscriber,
    build_map,
    diff_maps,
    rendezvous_route,
    weight_of,
    weight_seed,
)

__all__ = [
    "DEFAULT_WEIGHT_KEY",
    "MAX_WEIGHT",
    "PlacementConfig",
    "PlacementDiff",
    "PlacementEngine",
    "PlacementMap",
    "PlacementSubscriber",
    "build_map",
    "diff_maps",
    "rendezvous_route",
    "weight_of",
    "weight_seed",
]
