"""The port's protocol-plane transport: its own copies of the JAX package's
wire codec (``codec.py`` over ``msgpack_wire.py``), messaging seam
(``base.py``), retries, event-loop reactor, TCP transport, swarm gateway
(``gateway.py``), in-process network (``inprocess.py``), broadcasters
(``unicast.py``, ``gossip.py``) and port reservation (``ports.py``), so real
members reach each other and a swarm on the card in process or over a
socket. Standard library, numpy and torch only: no msgpack, no protobuf,
nothing of ``rapid_tpu``."""
