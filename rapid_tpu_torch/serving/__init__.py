"""Serving plane: a replicated Get/Put KV store over placement + handoff.

The port's own copy of ``rapid_tpu/serving/``: ``kv.py`` is the key space
and the on-store format, ``router.py``'s ``RendezvousRouter`` routes request
keys over the live membership, and ``engine.py``'s ``ServingEngine`` is the
live plane a member runs (``ClusterBuilder.use_serving``).
"""

from .engine import ServingEngine
from .kv import SERVING_SEED, decode_kv, encode_kv, partition_of
from .router import RendezvousRouter

__all__ = [
    "SERVING_SEED",
    "RendezvousRouter",
    "ServingEngine",
    "decode_kv",
    "encode_kv",
    "partition_of",
]
