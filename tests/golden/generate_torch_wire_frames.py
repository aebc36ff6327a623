"""Generate tests/golden/torch_wire_frames.json -- the wire bytes that
``rapid_tpu``'s codec gives for the frames of ``torch_wire_fixtures.corpus``,
which the port's codec (``rapid_tpu_torch/messaging/codec.py``, on its own
pure-Python MessagePack subset) must reproduce byte for byte.

Run from the repo root: python tests/golden/generate_torch_wire_frames.py

The committed JSON is the contract; ``tests/test_torch_wire_golden.py``
checks that ``rapid_tpu``'s codec still gives every frame, so the file
cannot drift. Regenerate only after a deliberate wire change.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import torch_wire_fixtures as fx  # noqa: E402


def main() -> None:
    wire = fx.jax_wire()
    frames = []
    for frame in fx.corpus():
        frames.append(dict(frame, hex=fx.frame_bytes(frame, wire).hex()))
    out = {
        "_provenance": (
            "generated by tests/golden/generate_torch_wire_frames.py with "
            "rapid_tpu.messaging.codec (msgpack 1.1); the port's codec must "
            "give every frame byte for byte"
        ),
        "frames": frames,
    }
    with open(os.path.join(HERE, "torch_wire_frames.json"), "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
