"""Event-loop I/O core for the messaging plane.

The port's own copy of ``rapid_tpu/messaging/reactor.py``. One ``Reactor`` is one I/O thread multiplexing every socket of a transport
through a ``selectors`` loop -- the replacement for the thread-per-connection
design (a reader thread per ``_Connection``, a thread per accepted socket,
plus the shared ``_TimeoutWheel`` deadline thread). The reference stacks its
transport on Netty's shared NIO event-loop group the same way
(SharedResources.java:63-67); this is that shape in pure Python.

Three mechanisms carry the throughput win:

- **Connection multiplexing**: every channel (dialed or accepted) registers
  with one selector; one thread wakes once per readable/writable batch
  instead of one blocked thread per socket.
- **Write coalescing**: ``Channel.send_frame`` only queues buffers; the
  reactor drains each dirty channel once per tick with a single
  scatter-gather ``sendmsg`` covering every queued frame -- one syscall per
  tick per peer, not one per message.
- **Zero-copy framing**: the read path parses length-prefixed frames as
  ``memoryview`` slices over the receive buffer (released before
  compaction); the write path keeps header and body as separate iovecs, so
  no per-frame ``bytes`` concatenation happens on either side.

Timers (``call_later``) replace the timeout wheel: request deadlines become
heap entries drained by the same loop. Nonblocking ``connect`` support lets
dials ride the reactor too, so a dead peer never blocks a sender thread.

Lockdep story: the reactor never holds two locks at once. Senders take
``Channel._wlock`` to queue buffers, release it, then take ``Reactor._lock``
to mark the channel dirty; the loop takes ``Reactor._lock`` to swap out the
dirty/pending/timer sets, releases it, then takes each channel's ``_wlock``
to swap its buffer queue -- every syscall (``sendmsg``/``recv``/``select``)
runs with no lock held.
"""

from __future__ import annotations

import errno
import heapq
import itertools
import logging
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..observability import MSG_BATCH_BUCKETS
from ..runtime.lockdep import make_lock
from .codec import HEADER

LOG = logging.getLogger(__name__)

MAX_FRAME_BYTES = 64 * 1024 * 1024
_HEADER_SIZE = HEADER.size
_RECV_CHUNK = 1 << 18
# conservative scatter-gather window (Linux IOV_MAX is 1024); larger queues
# drain in consecutive sendmsg calls within the same tick
_IOV_MAX = 512
_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")


class Timer:
    """Cancellable entry on a reactor's timer heap. ``cancel`` is a flag
    flip (GIL-atomic); a cancelled timer is skipped when it pops."""

    __slots__ = ("fn", "cancelled")

    def __init__(self, fn: Callable[[], None]) -> None:
        self.fn = fn
        self.cancelled = False  # guarded-by: gil-atomic

    def cancel(self) -> None:
        self.cancelled = True


class Reactor:
    """One I/O thread: selector + timer heap + pending-callable queue +
    dirty-channel flush set. The thread starts lazily on first use and runs
    as a daemon; ``stop()`` tears down every attached channel."""

    def __init__(self, name: str = "rapid-io") -> None:
        self._name = name
        self._selector = selectors.DefaultSelector()
        self._lock = make_lock("Reactor._lock")
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._running = True  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock
        self._pending: List[Callable[[], None]] = []  # guarded-by: _lock
        # dict used as an ordered set: flush order == first-dirty order
        self._dirty: Dict["Channel", bool] = {}  # guarded-by: _lock
        self._timers: List[Tuple[float, int, Timer]] = []  # guarded-by: _lock
        self._seq = itertools.count()
        self._channels: set = set()  # guarded-by: _lock
        # wake pipe: a byte written here breaks select() out of its wait
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, self)

    # -- scheduling (any thread) --------------------------------------------

    def call_soon(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if self._stopped:
                run_inline = True
            else:
                self._ensure_thread_locked()
                self._pending.append(fn)
                run_inline = False
        if run_inline:
            fn()  # post-stop cleanup (e.g. a late close) runs in place
        else:
            self._wake()

    def call_later(self, delay_s: float, fn: Callable[[], None]) -> Timer:
        timer = Timer(fn)
        with self._lock:
            self._ensure_thread_locked()
            heapq.heappush(
                self._timers,
                (time.monotonic() + delay_s, next(self._seq), timer),
            )
        self._wake()
        return timer

    def notify_dirty(self, channel: "Channel") -> None:
        with self._lock:
            self._ensure_thread_locked()
            self._dirty[channel] = True
        self._wake()

    @property
    def stopped(self) -> bool:
        with self._lock:
            return self._stopped

    def on_reactor_thread(self) -> bool:
        return threading.current_thread() is self._thread

    # -- channel lifecycle ---------------------------------------------------

    def _attach(self, channel: "Channel") -> None:
        with self._lock:
            self._ensure_thread_locked()
            self._channels.add(channel)
        if self.on_reactor_thread():
            self._register(channel)
        else:
            self.call_soon(lambda: self._register(channel))

    def _register(self, channel: "Channel") -> None:
        if channel._closed:  # noqa: SLF001 -- reactor/channel are one module
            return
        try:
            self._selector.register(channel.sock, channel._interest, channel)  # noqa: SLF001
            channel._registered = True  # noqa: SLF001
        except (KeyError, ValueError, OSError):
            channel.close(OSError(errno.EBADF, "socket not registrable"))

    def _detach(self, channel: "Channel") -> None:
        def finish() -> None:
            with self._lock:
                self._channels.discard(channel)
                self._dirty.pop(channel, None)
            if channel._registered:  # noqa: SLF001
                channel._registered = False  # noqa: SLF001
                try:
                    self._selector.unregister(channel.sock)
                except (KeyError, ValueError, OSError):
                    pass
            try:
                channel.sock.close()
            except OSError:
                pass

        if self.on_reactor_thread():
            finish()
        else:
            self.call_soon(finish)

    # -- loop ----------------------------------------------------------------

    def _ensure_thread_locked(self) -> None:
        if self._thread is None and self._running and not self._stopped:
            self._thread = threading.Thread(
                target=self._run, name=self._name, daemon=True
            )
            self._thread.start()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full means a wake is already pending; closed = stop

    def _on_events(self, mask: int) -> None:
        """Drain the wake pipe (the reactor registers itself for it)."""
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _run(self) -> None:
        while True:
            with self._lock:
                if not self._running:
                    break
                while self._timers and self._timers[0][2].cancelled:
                    heapq.heappop(self._timers)
                if self._pending or self._dirty:
                    timeout: Optional[float] = 0.0
                elif self._timers:
                    timeout = max(0.0, self._timers[0][0] - time.monotonic())
                else:
                    timeout = None
            try:
                events = self._selector.select(timeout)
            except OSError:
                events = []
            for key, mask in events:
                handler = key.data
                try:
                    handler._on_events(mask)  # noqa: SLF001
                except Exception:  # noqa: BLE001 -- one endpoint never kills the loop
                    LOG.exception("reactor handler failed")
            now = time.monotonic()
            with self._lock:
                due: List[Timer] = []
                while self._timers and (
                    self._timers[0][2].cancelled or self._timers[0][0] <= now
                ):
                    _, _, timer = heapq.heappop(self._timers)
                    if not timer.cancelled:
                        due.append(timer)
                pending, self._pending = self._pending, []
                dirty = list(self._dirty)
                self._dirty.clear()
            for timer in due:
                try:
                    timer.fn()
                except Exception:  # noqa: BLE001
                    LOG.exception("reactor timer failed")
            for fn in pending:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    LOG.exception("reactor callback failed")
            for channel in dirty:
                channel.flush()
        self._finalize()

    def _finalize(self) -> None:
        with self._lock:
            self._stopped = True
            channels = list(self._channels)
            self._channels.clear()
            self._pending.clear()
            self._dirty.clear()
            del self._timers[:]
        for channel in channels:
            try:
                channel.close(ConnectionError("reactor stopped"))
            except Exception:  # noqa: BLE001
                LOG.exception("channel close during reactor stop failed")
        try:
            self._selector.close()
        except OSError:
            pass
        for sock in (self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._running = False
            thread = self._thread
        self._wake()
        if thread is None:
            self._finalize()
        elif thread is not threading.current_thread():
            thread.join(timeout=2.0)


class Channel:
    """One nonblocking socket on a reactor: framed zero-copy reads, queued
    scatter-gather writes, optional in-flight nonblocking connect.

    ``on_frame(channel, view)`` receives each complete frame as a
    ``memoryview`` valid only for the duration of the call (copy with
    ``bytes(view)`` to retain). ``on_close(channel, exc)`` fires exactly
    once, from whichever thread closed the channel; ``on_connect(channel)``
    fires on the reactor thread when an outbound dial completes.
    """

    def __init__(
        self,
        reactor: Reactor,
        sock: socket.socket,
        on_frame: Callable[["Channel", memoryview], None],
        *,
        on_close: Optional[Callable[["Channel", Optional[BaseException]], None]] = None,
        on_connect: Optional[Callable[["Channel"], None]] = None,
        metrics=None,
        connecting: bool = False,
        connect_timeout_s: Optional[float] = None,
    ) -> None:
        sock.setblocking(False)
        try:
            # coalescing happens in the channel queue, not the kernel: turn
            # Nagle off so a flushed batch leaves immediately
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.reactor = reactor
        self.sock = sock
        self.connected = not connecting
        self._on_frame = on_frame
        self._on_close = on_close  # guarded-by: _wlock
        self._on_connect = on_connect
        self._metrics = metrics
        self._rbuf = bytearray()  # guarded-by: reactor-thread
        self._wlock = make_lock("Channel._wlock")
        self._wbufs: Deque[memoryview] = deque()  # guarded-by: _wlock
        self._wbytes = 0  # guarded-by: _wlock
        self._wframes = 0  # guarded-by: _wlock
        self._closed = False  # guarded-by: _wlock
        self._registered = False  # guarded-by: reactor-thread
        self._interest = (
            selectors.EVENT_WRITE if connecting else selectors.EVENT_READ
        )  # guarded-by: reactor-thread
        self._connect_timer: Optional[Timer] = None
        if connecting and connect_timeout_s is not None:
            self._connect_timer = reactor.call_later(
                connect_timeout_s, self._connect_timed_out
            )
        reactor._attach(self)  # noqa: SLF001 -- reactor/channel are one module

    @classmethod
    def connect(
        cls,
        reactor: Reactor,
        address: Tuple[str, int],
        timeout_s: float,
        on_frame: Callable[["Channel", memoryview], None],
        **kwargs,
    ) -> "Channel":
        """Dial without blocking: ``connect_ex`` starts the handshake and
        the reactor observes completion as writability. Frames queued while
        connecting are flushed the moment the connect completes; on failure
        or timeout the channel closes and ``on_close`` fires."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        err = sock.connect_ex(address)
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            try:
                sock.close()
            except OSError:
                pass
            raise OSError(err, os.strerror(err))
        return cls(
            reactor, sock, on_frame,
            connecting=(err != 0), connect_timeout_s=timeout_s, **kwargs,
        )

    # -- write side (any thread) --------------------------------------------

    def send_frame(self, frame: bytes) -> None:
        """Queue one length-prefixed frame. Header and body stay separate
        buffers all the way to the scatter-gather syscall -- no per-frame
        concatenation."""
        self.send_buffers((HEADER.pack(len(frame)), frame))

    def send_buffers(self, buffers: Tuple[bytes, ...], frames: int = 1) -> None:
        total = 0
        views = []
        for buf in buffers:
            if len(buf):
                views.append(memoryview(buf))
                total += len(buf)
        with self._wlock:
            if self._closed:
                raise OSError(errno.EPIPE, "channel closed")
            self._wbufs.extend(views)
            self._wbytes += total
            self._wframes += frames
        if self._metrics is not None:
            self._metrics.incr("msg.sent", frames)
        self.reactor.notify_dirty(self)

    def pending_bytes(self) -> int:
        with self._wlock:
            return self._wbytes

    def pending_frames(self) -> int:
        with self._wlock:
            return self._wframes

    def fileno(self) -> int:
        try:
            return self.sock.fileno()
        except OSError:
            return -1

    # -- reactor-thread handlers --------------------------------------------

    def _on_events(self, mask: int) -> None:
        if not self.connected and mask & selectors.EVENT_WRITE:
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self.close(OSError(err, os.strerror(err)))
                return
            self._complete_connect()
            return  # _complete_connect flushed; reads start next tick
        if mask & selectors.EVENT_READ:
            self._on_readable()
        if mask & selectors.EVENT_WRITE and self.connected:
            self.flush()

    def _complete_connect(self) -> None:
        self.connected = True
        if self._connect_timer is not None:
            self._connect_timer.cancel()
            self._connect_timer = None
        self._update_interest(selectors.EVENT_READ)
        if self._on_connect is not None:
            try:
                self._on_connect(self)
            except Exception:  # noqa: BLE001
                LOG.exception("on_connect callback failed")
        self.flush()

    def _connect_timed_out(self) -> None:
        if not self.connected:
            self.close(socket.timeout("connect timed out"))

    def _update_interest(self, mask: int) -> None:
        if mask == self._interest:
            return
        self._interest = mask
        if self._registered:
            try:
                self.reactor._selector.modify(self.sock, mask, self)  # noqa: SLF001
            except (KeyError, ValueError, OSError):
                pass

    def _on_readable(self) -> None:
        try:
            data = self.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self.close(e)
            return
        if not data:
            self.close(None)  # clean EOF
            return
        if self._metrics is not None:
            self._metrics.incr("msg.bytes_received", len(data))
        self._rbuf += data
        consumed, frames, err = self._parse_frames()
        if consumed:
            try:
                del self._rbuf[:consumed]
            except BufferError:
                # a frame handler leaked a view past its call; fall back to
                # a copying compaction rather than corrupting the stream
                self._rbuf = bytearray(bytes(self._rbuf[consumed:]))
        if frames and self._metrics is not None:
            self._metrics.incr("msg.received", frames)
        if err is not None:
            self.close(err)

    def _parse_frames(self) -> Tuple[int, int, Optional[BaseException]]:
        """Dispatch every complete frame in the read buffer as a memoryview
        slice. All views are released before returning, so the caller may
        compact the buffer in place."""
        total = len(self._rbuf)
        offset = 0
        frames = 0
        err: Optional[BaseException] = None
        view = memoryview(self._rbuf)
        try:
            while not self._closed and total - offset >= _HEADER_SIZE:
                (length,) = HEADER.unpack_from(view, offset)
                if length > MAX_FRAME_BYTES:
                    err = ValueError(f"oversized frame: {length}")
                    break
                end = offset + _HEADER_SIZE + length
                if end > total:
                    break
                frame = view[offset + _HEADER_SIZE:end]
                try:
                    self._on_frame(self, frame)
                except Exception as e:  # noqa: BLE001 -- poisoned frame closes
                    # the connection, never the reactor; drop the traceback
                    # so its frames stop pinning buffer views
                    e.__traceback__ = None
                    err = e
                finally:
                    try:
                        frame.release()
                    except BufferError:
                        pass
                if err is not None:
                    break
                offset = end
                frames += 1
        finally:
            try:
                view.release()
            except BufferError:
                pass
        return offset, frames, err

    def flush(self) -> None:
        """Drain the outbound queue: swap it out under the channel lock,
        then issue as few ``sendmsg`` syscalls as the iovec window allows
        with no lock held. Reactor thread only. Partial writes re-queue at
        the front and arm write interest."""
        if not self.connected:
            return
        with self._wlock:
            if self._closed or not self._wbufs:
                drained = True
                buffers: List[memoryview] = []
                frames = 0
            else:
                drained = False
                buffers = list(self._wbufs)
                self._wbufs.clear()
                frames = self._wframes
                self._wframes = 0
                self._wbytes = 0
        if drained:
            if self._interest & selectors.EVENT_WRITE:
                self._update_interest(selectors.EVENT_READ)
            return
        sent_bytes = 0
        syscalls = 0
        error: Optional[OSError] = None
        idx = 0
        while idx < len(buffers):
            window = buffers[idx:idx + _IOV_MAX]
            want = sum(len(b) for b in window)
            try:
                if _HAS_SENDMSG:
                    n = self.sock.sendmsg(window)
                else:  # pragma: no cover - platforms without scatter-gather
                    n = self.sock.send(b"".join(window))
            except (BlockingIOError, InterruptedError):
                break
            except OSError as e:
                error = e
                break
            syscalls += 1
            sent_bytes += n
            remaining = n
            while remaining > 0:
                buf = buffers[idx]
                if remaining >= len(buf):
                    remaining -= len(buf)
                    idx += 1
                else:
                    buffers[idx] = buf[remaining:]
                    remaining = 0
            if n < want:
                break  # kernel buffer full; wait for writability
        if self._metrics is not None and syscalls:
            self._metrics.incr("msg.flush_syscalls", syscalls)
            self._metrics.incr("msg.bytes_sent", sent_bytes)
            self._metrics.observe(
                "msg.batch_size", frames, buckets=MSG_BATCH_BUCKETS
            )
        if error is not None:
            self.close(error)
            return
        leftover = buffers[idx:]
        if leftover:
            nbytes = sum(len(b) for b in leftover)
            with self._wlock:
                if not self._closed:
                    self._wbufs.extendleft(reversed(leftover))
                    self._wbytes += nbytes
            self._update_interest(
                selectors.EVENT_READ | selectors.EVENT_WRITE
            )
        elif self._interest & selectors.EVENT_WRITE:
            self._update_interest(selectors.EVENT_READ)

    # -- lifecycle -----------------------------------------------------------

    def close(self, exc: Optional[BaseException] = None) -> None:
        with self._wlock:
            if self._closed:
                return
            self._closed = True
            self._wbufs.clear()
            self._wbytes = 0
            self._wframes = 0
            callback = self._on_close
            self._on_close = None
        if self._connect_timer is not None:
            self._connect_timer.cancel()
        try:
            # immediate FIN even when called off the reactor thread; the fd
            # itself is closed on the reactor thread via _detach
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.reactor._detach(self)  # noqa: SLF001
        if callback is not None:
            try:
                callback(self, exc)
            except Exception:  # noqa: BLE001
                LOG.exception("on_close callback failed")


class Acceptor:
    """A listening socket on the reactor: accepts until EAGAIN each tick
    and hands fresh sockets to ``on_accept`` on the reactor thread."""

    def __init__(
        self,
        reactor: Reactor,
        sock: socket.socket,
        on_accept: Callable[[socket.socket], None],
    ) -> None:
        sock.setblocking(False)
        self.reactor = reactor
        self.sock = sock
        self._on_accept = on_accept
        self._closed = False
        self._registered = False  # guarded-by: reactor-thread
        self._interest = selectors.EVENT_READ
        reactor._attach(self)  # type: ignore[arg-type]  # duck-typed channel

    def _on_events(self, mask: int) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            try:
                self._on_accept(conn)
            except Exception:  # noqa: BLE001 -- one bad accept never kills the loop
                LOG.exception("accept handler failed")
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self, exc: Optional[BaseException] = None) -> None:
        del exc  # listening sockets owe nobody an error; duck-typed Channel
        if self._closed:
            return
        self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.reactor._detach(self)  # type: ignore[arg-type]  # noqa: SLF001


# Process-wide reactor for clients that have no transport of their own
# (GatewayRoutedClient's single upstream connection): lazily created on the
# first dial, replaced if a test stopped it, never stopped by its users --
# the same lifetime discipline as the old module-global timeout wheel.
_shared_lock = make_lock("reactor._shared_lock")
_shared: Optional[Reactor] = None


def shared_reactor() -> Reactor:
    global _shared
    with _shared_lock:
        if _shared is None or _shared.stopped:
            _shared = Reactor(name="rapid-io-shared")
        return _shared
