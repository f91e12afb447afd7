"""Free TCP ports for the rendezvous of spawned process groups.

A port from ``bind(("", 0))`` lies in the kernel's ephemeral range, where
any socket bound to port 0 (the core's van, gloo's pairs) or any outgoing
connection may take it between the pick and the bind of the process it is
handed to (EADDRINUSE). Outside that range only an explicit bind can take
a port, so ``free_port`` picks there.
"""

from __future__ import annotations

import random
import socket
import threading

# From 10000: clear of the monitor's 9100 + node id and of well-known ports.
_LOWEST = 10000
_RANGE_FILE = "/proc/sys/net/ipv4/ip_local_port_range"

_given = set()
_lock = threading.Lock()


def ephemeral_range() -> tuple:
    """(low, high) of the kernel's ephemeral ports, both included."""
    with open(_RANGE_FILE) as f:
        low, high = (int(x) for x in f.read().split())
    return low, high


def _candidates() -> list:
    """Ports from 10000 outside the ephemeral range. The range differs
    between machines (32768-60999 by default, 16000-65535 on some); where
    it leaves nothing, every port from 10000."""
    low, high = ephemeral_range()
    return ([p for p in range(_LOWEST, 65536) if not low <= p <= high]
            or list(range(_LOWEST, 65536)))


def free_port() -> int:
    """A TCP port that nothing is bound to (checked by binding it), outside
    the kernel's ephemeral range, and never the same twice in a process."""
    span = _candidates()
    pick = random.SystemRandom()
    for _ in range(256):
        port = pick.choice(span)
        with _lock:
            if port in _given:
                continue
            with socket.socket() as s:
                try:
                    s.bind(("", port))
                except OSError:
                    continue
            _given.add(port)
        return port
    raise RuntimeError(f"no free port among {len(span)} from {span[0]}")
