"""Serving plane: a replicated Get/Put KV store over placement + handoff.

``kv.py`` is the key space and the on-store format the simulator's serving
plane uses; ``router.py``'s ``RendezvousRouter`` routes request keys over
the live membership. The live ``ServingEngine``
(``rapid_tpu/serving/engine.py``) serves the protocol plane and is not
ported yet (ROADMAP.md, Queue 1 item 12).
"""

from .kv import SERVING_SEED, decode_kv, encode_kv, partition_of
from .router import RendezvousRouter

__all__ = ["SERVING_SEED", "RendezvousRouter", "decode_kv", "encode_kv", "partition_of"]
