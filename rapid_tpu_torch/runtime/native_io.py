"""ctypes binding for the port's native framed-TCP reactor
(``csrc/host/rapid_io.cpp``).

The counterpart of ``rapid_tpu/runtime/native_io.py``, and the runtime-IO
analogue of the reference's shared Netty event-loop group
(SharedResources.java:48-67, NettyClientServer.java:65): a single epoll
thread in C++ multiplexes every accepted connection of a server, replacing
the Python transport's thread-per-connection readers. Frames cross the
boundary through a poll()-style event queue; payload parsing (request-no,
type tag, MessagePack body) stays in ``rapid_tpu_torch.messaging.codec``.

The source is built with ``-pthread`` by ``native.open_library``, as the
port's hashing library is: ``g++`` at first use into ``build/native/``.
``load()`` returns None when the library cannot be built or loaded, with
one ``RuntimeWarning`` carrying the compiler's output and the reason in
``native.ERRORS["rapid_io"]``; callers then keep the pure-Python
``FramedTcpServer``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

SOURCE = "rapid_io.cpp"
CXX_FLAGS = ("-pthread",)

_lib: Optional[ctypes.CDLL] = None
_tried = False

# poll() event types (contract in rapid_io.cpp)
EV_NONE = 0
EV_FRAME = 1
EV_CLOSED = 2
EV_SHUTDOWN = -1


def load(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    from .. import native

    lib = native.open_library(SOURCE, CXX_FLAGS, auto_build=auto_build)
    if lib is None:
        _tried = auto_build
        return None
    _tried = True

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.rapid_io_server_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rapid_io_server_create.restype = i64
    lib.rapid_io_server_port.argtypes = [i64]
    lib.rapid_io_server_port.restype = ctypes.c_int
    lib.rapid_io_server_poll.argtypes = [
        i64, ctypes.POINTER(i64), u8p, i64, ctypes.POINTER(i64), ctypes.c_int
    ]
    lib.rapid_io_server_poll.restype = ctypes.c_int
    lib.rapid_io_server_send.argtypes = [i64, i64, u8p, i64]
    lib.rapid_io_server_send.restype = ctypes.c_int
    lib.rapid_io_server_shutdown.argtypes = [i64]
    lib.rapid_io_server_shutdown.restype = None
    _lib = lib
    return lib


def available(auto_build: bool = True) -> bool:
    return load(auto_build) is not None


class NativeReactor:
    """One native server: epoll accept/read loop plus a framed send path.

    Events are drained with :meth:`poll`; replies go out with :meth:`send`.
    ``conn_id`` is the reactor's identity for an accepted connection and is
    the reply address for its frames.
    """

    def __init__(self, host: str, port: int) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError(f"native reactor unavailable ({SOURCE} did not build or load)")
        self._lib = lib
        handle = lib.rapid_io_server_create(host.encode(), port)
        if handle < 0:
            raise OSError(-handle, os.strerror(-handle))
        self._handle = handle
        self.port = lib.rapid_io_server_port(handle)
        self._buf = np.empty(1 << 20, dtype=np.uint8)  # grows on demand

    def poll(self, timeout_ms: int = 500):
        """Next event as ``(type, conn_id, payload-or-None)``; type is one of
        the EV_* constants (EV_NONE on timeout, EV_SHUTDOWN after shutdown)."""
        conn_id = ctypes.c_int64()
        length = ctypes.c_int64()
        ev = self._lib.rapid_io_server_poll(
            self._handle, ctypes.byref(conn_id), self._buf,
            self._buf.shape[0], ctypes.byref(length), timeout_ms,
        )
        if ev == EV_FRAME:
            if length.value > self._buf.shape[0]:
                # frame larger than the buffer: the event stayed queued
                self._buf = np.empty(int(length.value), dtype=np.uint8)
                return self.poll(timeout_ms)
            payload = bytes(self._buf[: length.value])
            return EV_FRAME, conn_id.value, payload
        return ev, conn_id.value, None

    def send(self, conn_id: int, frame: bytes) -> bool:
        arr = np.frombuffer(frame, dtype=np.uint8)
        return (
            self._lib.rapid_io_server_send(
                self._handle, conn_id, arr, arr.shape[0]
            )
            == 0
        )

    def shutdown(self) -> None:
        self._lib.rapid_io_server_shutdown(self._handle)
