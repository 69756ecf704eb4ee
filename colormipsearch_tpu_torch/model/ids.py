"""Time-based unique entity IDs.

Same layout as the reference generator (colormipsearch-persist
dao/TimebasedIdGenerator.java:10-95):

    id = (millis - OFFSET) << 22 | blockIndex << 12 | context << 8 | ipOctet

with 1024-id blocks per millisecond and a 1 ms spin when a block is
exhausted within the same tick.
"""

from __future__ import annotations

import socket
import threading
import time

_CURRENT_TIME_OFFSET = 921_700_000_000
_BLOCK_SIZE = 1024
_MAX_DEPLOYMENT_CONTEXT = 15


def _ip_component() -> int:
    try:
        addr = socket.gethostbyname(socket.gethostname())
        return int(addr.split(".")[-1]) & 0xFF
    except OSError:
        return 0


class TimebasedIdGenerator:
    def __init__(self, deployment_context: int = 0, ip_component: int | None = None):
        if not 0 <= deployment_context <= _MAX_DEPLOYMENT_CONTEXT:
            raise ValueError(
                f"deployment context must be in 0..{_MAX_DEPLOYMENT_CONTEXT}")
        self._context = deployment_context
        self._ip = _ip_component() if ip_component is None else ip_component & 0xFF
        self._lock = threading.Lock()
        self._time_component = -1
        self._index = _BLOCK_SIZE  # force a new block on first use

    def _new_block_locked(self) -> None:
        t = int(time.time() * 1000) - _CURRENT_TIME_OFFSET
        if t == self._time_component:
            time.sleep(0.001)
            t = int(time.time() * 1000) - _CURRENT_TIME_OFFSET
        if t <= self._time_component:
            # clock stepped backwards (NTP): advance the logical tick
            # instead of re-issuing an already-used block (the reference
            # generator would duplicate here, TimebasedIdGenerator.java:73)
            t = self._time_component + 1
        self._time_component = t
        self._index = 0

    def generate_id(self) -> int:
        with self._lock:
            if self._index >= _BLOCK_SIZE:
                self._new_block_locked()
            i = self._index
            self._index += 1
            return ((self._time_component << 22) | (i << 12)
                    | (self._context << 8) | self._ip)

    def generate_id_list(self, n: int) -> list[int]:
        return [self.generate_id() for _ in range(n)]
