"""The port's wire codec against frames recorded with ``rapid_tpu``'s.

``tests/golden/torch_wire_frames.json`` holds frames written by
``rapid_tpu.messaging.codec`` (``tests/golden/generate_torch_wire_frames.py``):
at least one for each of the 28 codec tags, the reserved ``__tc``/``__hlc``
envelope keys, the ``__al`` and ``__msg`` inner forms, routed frames (one
to the swarm broadcast), other wire dialects, a 5000-endpoint
``JoinResponse`` (the large-tuple memo) and ints, strings and bins at
every msgpack width boundary. Each frame is held two ways: ``rapid_tpu``'s
codec still gives it (the file cannot drift), and the port's codec gives
the same bytes and decodes them back to an equal message with its trace
context and HLC stamp."""

import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent / "golden"))

import torch_wire_fixtures as fx  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

FRAMES = json.loads(
    (Path(__file__).parent / "golden" / "torch_wire_frames.json").read_text())["frames"]
IDS = [f["name"] for f in FRAMES]
JAX, PORT = fx.jax_wire(), fx.port_wire()


def _tag(frame: dict, data: bytes) -> int:
    if frame["routed"] is None:
        return data[8]
    host_len = int.from_bytes(data[8:10], "big")
    return data[10 + host_len + 4]


def test_the_file_covers_every_tag_and_form():
    from rapid_tpu.messaging.codec import _TYPES

    tags = {_tag(f, bytes.fromhex(f["hex"])) for f in FRAMES}
    assert tags == set(range(len(_TYPES))) == set(range(28))
    blob = "".join(f["hex"] for f in FRAMES)
    for key in ("__tc", "__hlc", "__al", "__msg", "__v2"):
        assert key.encode().hex() in blob, key
    assert any(f["routed"] == "*" for f in FRAMES)
    assert any(f["version"] is not None for f in FRAMES)
    big = [f for f in FRAMES if f["name"] == "JoinResponse_5000_endpoints"]
    assert len(big) == 1 and len(fx.value(big[0]["message"], PORT.types).endpoints) == 5000


@pytest.mark.parametrize("frame", FRAMES, ids=IDS)
def test_jax_codec_still_gives_the_frame(frame):
    assert fx.frame_bytes(frame, JAX).hex() == frame["hex"]


@pytest.mark.parametrize("frame", FRAMES, ids=IDS)
def test_port_codec_gives_the_frame_and_decodes_it_back(frame):
    data = bytes.fromhex(frame["hex"])
    assert fx.frame_bytes(frame, PORT) == data
    want = fx.message(frame, PORT)
    if frame["routed"] is not None:
        request_no, dst, got = PORT.decode_routed(data)
        assert dst == fx.destination(frame, PORT)
    else:
        request_no, got = PORT.decode(memoryview(data))
    assert request_no == frame["request_no"]
    assert type(got) is type(want) and got == want
    assert type(got).__module__ == "rapid_tpu_torch.types"
    # a dialect below 1 predates the trace context; the HLC stamp rides
    # only where the frame carries it
    old_dialect = frame["version"] is not None and frame["version"] < 1
    tc = None if old_dialect else PORT.trace_context_of(want)
    assert PORT.trace_context_of(got) == tc
    assert PORT.hlc_of(got) == PORT.hlc_of(want)
