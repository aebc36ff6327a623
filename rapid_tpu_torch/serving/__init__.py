"""Serving plane: a replicated Get/Put KV store over placement + handoff.

``kv.py`` is the key space and the on-store format the simulator's serving
plane uses. The live ``ServingEngine`` (``rapid_tpu/serving/engine.py``)
and ``RendezvousRouter`` (``router.py``) serve the protocol plane and are
not ported yet (ROADMAP.md, Queue 1).
"""

from .kv import SERVING_SEED, decode_kv, encode_kv, partition_of

__all__ = ["SERVING_SEED", "decode_kv", "encode_kv", "partition_of"]
