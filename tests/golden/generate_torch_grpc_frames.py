"""Generate tests/golden/torch_grpc_frames.json -- what grpcio puts on the
wire for three unary calls on one connection, captured byte for byte in
both directions by a recording proxy between grpcio's client and a server:
a probe (a reply of headers, DATA and trailers), a ``LeaveMessage`` before
the membership service is wired (a trailers-only UNAVAILABLE reply), and a
probe carrying a ``-bin`` metadata key. Two servers: ``rapid_tpu``'s
``GrpcServer`` (grpc.aio, so both directions are grpcio's; its SETTINGS
offer binary metadata, id 0xfe03, and grpcio's client sends the value raw)
and the port's ``GrpcServer``, which does not offer it (grpcio's client then
sends the value base64-coded under Huffman).

Run from the repo root, where grpcio is installed:
    python tests/golden/generate_torch_grpc_frames.py

Each capture keeps its calls' outcomes, and each direction its hex, its
frames (type, flags, stream, length) and its header blocks as the port's
HPACK decoder reads them, one decoder a direction in arrival order
(``chip_smoke.decode_capture``).
``tests/test_torch_grpc_transport.py`` checks that a fresh capture decodes
to the same header blocks but for the per-run values (``PER_RUN``: the
proxy's port in ``:authority`` and the ``grpc-timeout`` left), and
``chip_smoke.py`` replays the file on a machine without grpcio.
Regenerate only after a deliberate change.
"""

import json
import os
import socket
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

TIMEOUT_S = 1.5
BIN_KEY = "x-rapid-trace-bin"
BIN_VALUE = bytes(range(0, 256, 5))
PER_RUN = (":authority", "grpc-timeout")
SERVERS = ("rapid_tpu", "rapid_tpu_torch")  # whose GrpcServer answers grpcio's client


def calls(T):
    me = T.Endpoint.from_parts("10.0.0.1", 5000)
    return (("probe", T.ProbeMessage(sender=me), ()),
            ("leave before the service", T.LeaveMessage(sender=me), ()),
            ("probe with -bin metadata", T.ProbeMessage(sender=me), ((BIN_KEY, BIN_VALUE),)))


def _pump(src: socket.socket, dst: socket.socket, into: bytearray) -> None:
    try:
        while True:
            data = src.recv(65536)
            if not data:
                break
            into += data
            dst.sendall(data)
    except OSError:
        pass
    finally:
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass


def capture(server_package: str):
    """(client bytes, server bytes, each call's outcome) of the three calls
    from grpcio's client through a recording proxy to ``server_package``'s
    ``GrpcServer``."""
    import importlib

    import grpc

    from rapid_tpu import types as T
    from rapid_tpu.messaging import grpc_transport as gt
    from rapid_tpu.messaging.ports import free_port_base
    from rapid_tpu.messaging.wire_schema import GRPC_METHOD_PATH, MSG

    P = importlib.import_module(f"{server_package}.messaging.grpc_transport")
    PT = importlib.import_module(f"{server_package}.types")
    server = P.GrpcServer(PT.Endpoint.from_parts("127.0.0.1", free_port_base(1)))
    server.start()
    listener = socket.create_server(("127.0.0.1", 0))
    sent = {"client": bytearray(), "server": bytearray()}
    threads, socks = [], []

    def accept() -> None:
        down, _ = listener.accept()
        up = socket.create_connection(("127.0.0.1", server.address.port))
        socks.extend((down, up))
        for src, dst, side in ((down, up, "client"), (up, down, "server")):
            t = threading.Thread(target=_pump, args=(src, dst, sent[side]), daemon=True)
            t.start()
            threads.append(t)

    acceptor = threading.Thread(target=accept, daemon=True)
    acceptor.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{listener.getsockname()[1]}",
                                    options=[("grpc.use_local_subchannel_pool", 1)])
    stub = channel.unary_unary(GRPC_METHOD_PATH,
                               request_serializer=lambda m: m.SerializeToString(),
                               response_deserializer=MSG["RapidResponse"].FromString)
    outcomes = []
    try:
        for name, msg, metadata in calls(T):
            try:
                reply = stub(gt.to_wire_request(msg), timeout=TIMEOUT_S, metadata=metadata)
                outcomes.append([name, repr(gt.from_wire_response(reply))])
            except grpc.RpcError as e:
                outcomes.append([name, f"{e.code().name}: {e.details()}"])
    finally:
        channel.close()
        server.shutdown()
        acceptor.join(10)
        for t in threads:
            t.join(10)
        for s in socks + [listener]:
            s.close()
    return bytes(sent["client"]), bytes(sent["server"]), outcomes


def masked(blocks):
    """Header blocks with the per-run values blanked."""
    return [{"stream": b["stream"], "headers": [[n, "" if n in PER_RUN else v]
                                                for n, v in b["headers"]]}
            for b in blocks]


def main() -> None:
    import grpc

    sys.path.insert(0, ROOT)
    import chip_smoke

    captures = {}
    for package in SERVERS:
        client, server, outcomes = capture(package)
        captures[package] = {
            "calls": outcomes,
            "client": dict(chip_smoke.decode_capture(client, client_side=True), hex=client.hex()),
            "server": dict(chip_smoke.decode_capture(server, client_side=False),
                           hex=server.hex()),
        }
    doc = {
        "_provenance": (
            "generated by tests/golden/generate_torch_grpc_frames.py: grpcio's client "
            "against rapid_tpu's and the port's GrpcServer through a recording proxy; "
            "header blocks as rapid_tpu_torch.messaging.http2 decodes them "
            "(chip_smoke.decode_capture)"
        ),
        "grpcio": grpc.__version__,
        "bin_metadata": [BIN_KEY, BIN_VALUE.hex()],
        "captures": captures,
    }
    with open(os.path.join(HERE, "torch_grpc_frames.json"), "w") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
