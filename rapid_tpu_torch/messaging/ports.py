"""Loopback port-block reservation for examples, tools, and tests.

The port's own copy of ``rapid_tpu/messaging/ports.py``.

A rapid node's endpoint is its ring identity (MembershipView orders members
by seeded endpoint hashes), so it must be chosen BEFORE the server binds --
kernel-assigned port 0 cannot flow through the protocol. Everything that
launches multi-node scenarios on one machine therefore picks a base port and
derives node addresses base+i; this helper probes the whole block bindable
at pick time, so two concurrent batteries/examples cannot collide on
already-listening ports (the failure mode of blind random picks)."""

from __future__ import annotations

import random
import socket


def free_port_base(count: int = 1, tries: int = 64,
                   lo: int = 20000, hi: int = 32000) -> int:
    """A base port whose whole [base, base+count] block binds NOW.

    ``hi`` stays below the kernel's ephemeral source-port floor (32768 by
    default): a reserved port inside that range can be stolen between
    reservation and bind by any outgoing connection's kernel-assigned
    source port -- observed as EADDRINUSE on agents binding minutes after
    their block was probed free."""
    for _ in range(tries):
        base = random.randint(lo, hi - count - 1)
        socks = []
        try:
            for off in range(count + 1):
                s = socket.socket()
                s.bind(("127.0.0.1", base + off))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no free block of {count} ports after {tries} tries")


def free_port() -> int:
    return free_port_base(1)
