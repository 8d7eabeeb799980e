"""LZC-based Weighted-Round-Robin arbiter (§IV-E.1).

Each *slave* port owns one arbiter (decentralised arbitration). The arbiter:

- grants one requesting master at a time, in rotating-priority order starting
  from the port after the last grant (round robin);
- picks the next requester with a leading-zero count over the rotated request
  vector (the Oklobdzija LZC construction the paper cites [31], which is why
  this arbiter is smaller/faster than priority-encoder arbiters [32]);
- enforces *weights* as package quotas: a package counter compares against the
  register-file quota for (this slave, granted master) and switches the grant
  when the quota is exhausted — bandwidth is allocated in packages, not time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


def lzc32(x: int) -> int:
    """Leading-zero count of a 32-bit value (the arbiter's priority primitive)."""
    x &= 0xFFFFFFFF
    if x == 0:
        return 32
    n = 0
    for shift in (16, 8, 4, 2, 1):
        if x >> (32 - n - shift) == 0:
            n += shift
    return n


def rotl(x: int, r: int, width: int) -> int:
    """Rotate-left of an n-bit request vector."""
    r %= width
    mask = (1 << width) - 1
    x &= mask
    return ((x << r) | (x >> (width - r))) & mask


def first_requester(requests: int, start: int, n_ports: int) -> Optional[int]:
    """Index of the first asserted request at/after ``start`` (wrapping).

    Hardware realisation: rotate the request vector so ``start`` lands at bit
    0, isolate the lowest set bit (``x & -x``), and locate it with the LZC —
    pure bit-ops so the simulator matches the circuit's grant order exactly.
    """
    if requests == 0:
        return None
    mask = (1 << n_ports) - 1
    rot = rotl(requests & mask, n_ports - (start % n_ports), n_ports)
    lowest = rot & -rot                      # one-hot lowest-priority-distance
    offset = 31 - lzc32(lowest)              # trailing-zero count via LZC
    return (start + offset) % n_ports


@dataclass
class WRRArbiter:
    """Per-slave-port WRR arbiter with package counters.

    ``quotas[i]`` = max packages master ``i`` may send per grant session
    (from the register file's PKGS_PORT<slave> register). A quota of 0 means
    "unlimited" (register not programmed — the hardware comparator never
    fires).
    """

    n_ports: int
    quotas: List[int]
    last_grant: int = -1          # round-robin pointer (start before port 0)
    current_grant: Optional[int] = None
    package_count: int = 0
    grants_issued: int = 0
    preemptions: int = 0

    def grant_next(self, request_vector: int) -> Optional[int]:
        """Arbitrate among asserted requests; returns granted master or None.

        Called when the slave is free. Models the 2-cc arbitration decision
        (the latency is accounted by the crossbar simulator; this function is
        the combinational grant order).
        """
        start = (self.last_grant + 1) % self.n_ports
        winner = first_requester(request_vector, start, self.n_ports)
        if winner is None:
            return None
        self.current_grant = winner
        self.last_grant = winner
        self.package_count = 0
        self.grants_issued += 1
        return winner

    def on_package(self) -> bool:
        """Count one transferred package; True if the quota is now exhausted.

        "When the maximum number of packages is reached, it switches the grant
        to the next master." (§IV-E.1)
        """
        if self.current_grant is None:
            raise RuntimeError("package transfer with no active grant")
        self.package_count += 1
        quota = self.quotas[self.current_grant]
        if quota and self.package_count >= quota:
            self.preemptions += 1
            return True
        return False

    def release(self) -> None:
        self.current_grant = None
        self.package_count = 0
