"""The port's protocol-plane transport: its own copies of the JAX package's
wire codec (``codec.py`` over ``msgpack_wire.py``), messaging seam
(``base.py``), retries, event-loop reactor, TCP transport and swarm gateway
(``gateway.py``), so real agents reach a swarm on the card over a socket.
Standard library, numpy and torch only: no msgpack, no protobuf, nothing of
``rapid_tpu``."""
