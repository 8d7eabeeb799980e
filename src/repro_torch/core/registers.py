"""Crossbar register file (paper Table III) as a frozen record of tensors.

The register file is the cheap reconfiguration surface: rewriting
destinations, isolation masks or package quotas re-routes module traffic
without rebuilding any kernel, because the kernels take registers as
values (pointer arguments), never as compile-time constants.

Dtypes are exact: int32 for ports, quotas, capacities, errors and the
version, bool for the isolation and reset masks.  Every write returns a
new record and bumps ``version`` once.
"""
from __future__ import annotations

import dataclasses

import torch


class ErrorCode:
    """Transaction error codes, identical to the hardware enum."""
    OK = 0
    INVALID_DEST = 1     # isolation violation (allowed-mask AND == 0)
    GRANT_TIMEOUT = 2    # no slot within the arbitration window (dropped)
    ACK_TIMEOUT = 3      # destination over capacity (stalled & dropped)


def _idx(values, device) -> torch.Tensor:
    return torch.as_tensor(list(values), dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class CrossbarRegisters:
    """Configuration consumed by the crossbar dispatch.

    - ``dest``      [n_modules]        module -> destination port
    - ``allowed``   [n_ports, n_ports] isolation masks, allowed[src, dst]
    - ``quota``     [n_ports, n_ports] WRR package quotas, quota[dst, src];
                                       0 == unlimited
    - ``capacity``  [n_ports]          receive-slot count per destination
    - ``reset``     [n_ports]          ports held in reset grant nothing
    - ``error``     [n_ports]          last-transaction error status
    - ``version``   []                 bumped on every write
    """

    dest: torch.Tensor
    allowed: torch.Tensor
    quota: torch.Tensor
    capacity: torch.Tensor
    reset: torch.Tensor
    error: torch.Tensor
    version: torch.Tensor

    @property
    def n_ports(self) -> int:
        return self.allowed.shape[0]

    @property
    def device(self) -> torch.device:
        return self.allowed.device

    @staticmethod
    def create(n_ports: int, *, n_modules: int | None = None,
               capacity: int = 8, device="cpu") -> "CrossbarRegisters":
        n_modules = n_ports if n_modules is None else n_modules
        i32 = dict(dtype=torch.int32, device=device)
        return CrossbarRegisters(
            dest=torch.arange(n_modules, **i32) % n_ports,
            allowed=torch.ones((n_ports, n_ports), dtype=torch.bool,
                               device=device),
            quota=torch.zeros((n_ports, n_ports), **i32),
            capacity=torch.full((n_ports,), capacity, **i32),
            reset=torch.zeros((n_ports,), dtype=torch.bool, device=device),
            error=torch.zeros((n_ports,), **i32),
            version=torch.zeros((), **i32),
        )

    def to(self, device) -> "CrossbarRegisters":
        """The same file on ``device`` (one copy per field)."""
        return CrossbarRegisters(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    # The write port: functional updates that bump the version counter.
    def write(self, **updates) -> "CrossbarRegisters":
        new = dataclasses.replace(self, **updates)
        return dataclasses.replace(new, version=self.version + 1)

    def patch(self, *, dest=(), allowed=(), reset=()) -> "CrossbarRegisters":
        """Incremental write port: scatter sparse entry updates in one epoch.

        ``dest``: ``(port, new_dest)`` pairs; ``allowed``: ``(src, dst,
        value)`` triples; ``reset``: ``(port, value)`` pairs.  Out-of-range
        entries are dropped.  Bumps ``version`` exactly once, even when
        every update list is empty.
        """
        d, a, r = self.dest.clone(), self.allowed.clone(), self.reset.clone()
        if dest:
            idx, vals = zip(*dest)
            _set_drop(d, (idx,), vals)
        if allowed:
            src, dst, vals = zip(*allowed)
            _set_drop(a, (src, dst), vals)
        if reset:
            idx, vals = zip(*reset)
            _set_drop(r, (idx,), vals)
        return self.write(dest=d, allowed=a, reset=r)

    def with_isolation(self, src: int, allowed_dsts) -> "CrossbarRegisters":
        row = torch.zeros((self.n_ports,), dtype=torch.bool,
                          device=self.device)
        _set_drop(row, (list(allowed_dsts),), [True] * len(allowed_dsts))
        mask = self.allowed.clone()
        if 0 <= src < self.n_ports:
            mask[src] = row
        return self.write(allowed=mask)

    def with_quota(self, dst: int, src: int, packages: int
                   ) -> "CrossbarRegisters":
        q = self.quota.clone()
        _set_drop(q, ([dst], [src]), [packages])
        return self.write(quota=q)

    def with_dest(self, module: int, dst: int) -> "CrossbarRegisters":
        d = self.dest.clone()
        _set_drop(d, ([module],), [dst])
        return self.write(dest=d)


def _set_drop(t: torch.Tensor, index, values) -> None:
    """``t[index] = values`` in place, dropping out-of-range entries (the
    ``mode="drop"`` scatter of the register write port)."""
    idx = [_idx(i, t.device) for i in index]
    vals = torch.as_tensor(list(values), dtype=t.dtype, device=t.device)
    ok = torch.ones_like(idx[0], dtype=torch.bool)
    for i, n in zip(idx, t.shape):
        ok &= (i >= 0) & (i < n)
    t[tuple(i[ok] for i in idx)] = vals[ok]



def validate_registers(regs: CrossbarRegisters) -> None:
    """Host-side invariant checks (used by tests and the shell's callers).

    Raises ``AssertionError`` with the JAX package's messages, explicitly so
    that ``python -O`` keeps the checks."""
    n = regs.n_ports
    checks = (
        (tuple(regs.allowed.shape) == (n, n), None),
        (tuple(regs.quota.shape) == (n, n), None),
        (bool((regs.quota >= 0).all()), "quotas are non-negative"),
        (bool((regs.capacity >= 0).all()), None),
        (bool((regs.dest >= 0).all()), None),
        (bool((regs.dest < n).all()), "destinations must be ports"),
    )
    for ok, msg in checks:
        if not ok:
            raise AssertionError(*(() if msg is None else (msg,)))
