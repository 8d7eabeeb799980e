"""Cycle-level simulator of the proposed NxN WB crossbar (§IV-E, §V-E).

Timing model — calibrated to the paper's own accounting, which we reproduce
exactly (§V-E):

- A module's request takes **2 cc** to reach the master interface and be
  initiated at the crossbar (isolation check happens here).
- The slave-port arbiter takes **2 cc** to grant and enable the slave, so the
  best-case *time-to-grant* (request → first data word) is **4 cc**.
- Data moves 1 word/cc. After the last word the master *releases the bus
  immediately*; one extra cc registers the transaction's error status on the
  master side only. Hence 8 packages ⇒ request completion = 4+8+1 = **13 cc**.
- A queued master observes the release and restarts the request/grant
  handshake, paying the full 4-cc time-to-grant again (the paper's worst case:
  "12 ccs for each previous master and 4 ccs for time-to-grant" ⇒ 28 cc grant /
  37 cc completion when 3 masters target the same slave).
- Invalid destination (one-hot address ANDed with the allowed mask is zero):
  the master port never issues a request; the error signal travels back in
  1 cc and the error code is registered the next cc (completion 5 cc after
  submission — the paper gives no number here, only the mechanism).
- WRR quota exhaustion preempts the grant: the master re-asserts its request
  (visible 2 cc after release) and rejoins arbitration.

The grant *order* is produced by the real LZC-based WRR arbiter
(:mod:`repro_torch.core.hw.arbiter`), so rotation/fairness behaviour matches the
circuit, not just the latency arithmetic.
"""
from __future__ import annotations

import enum
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.hw.arbiter import WRRArbiter
from repro_torch.core.hw.registers import RegisterFile

# Paper-calibrated pipeline latencies (clock cycles).
REQ_PIPE_CC = 2          # module request -> master port issues request
ARB_CC = 2               # arbiter decision + slave enable
TIME_TO_GRANT_CC = REQ_PIPE_CC + ARB_CC   # = 4 (best case, §V-E)
STATUS_CC = 1            # error-status registration after last word
REARB_OBSERVE_CC = 1     # master port observes bus release
REREQ_CC = 2             # re-assert request after release/preemption


class ErrorCode(enum.IntEnum):
    OK = 0
    INVALID_DEST = 1     # isolation violation: dst AND allowed == 0 (§IV-E.2)
    GRANT_TIMEOUT = 2    # watchdog expired waiting for a grant (§IV-F.1)
    ACK_TIMEOUT = 3      # destination unresponsive / stalled too long (§IV-F.1)


@dataclass(order=True)
class MasterRequest:
    """One master-interface transaction: send ``n_words`` to slave ``dst``."""

    cycle: int                       # cycle the module raises its request
    master: int = field(compare=False)
    dst_onehot: int = field(compare=False)   # one-hot slave address, e.g. 0b0010
    n_words: int = field(compare=False, default=8)
    app_id: int = field(compare=False, default=0)


@dataclass
class TransferResult:
    master: int
    slave: Optional[int]
    app_id: int
    submit_cycle: int
    first_word_cycle: Optional[int]   # None if the transfer never got a grant
    completion_cycle: int             # cycle the error status is registered
    words_sent: int
    grant_sessions: int
    error: ErrorCode

    @property
    def time_to_grant(self) -> Optional[int]:
        if self.first_word_cycle is None:
            return None
        return self.first_word_cycle - self.submit_cycle

    @property
    def completion_latency(self) -> int:
        # Inclusive cycle count: submit cycle .. status cycle.
        return self.completion_cycle - self.submit_cycle + 1


def _onehot_to_index(onehot: int, n_ports: int) -> Optional[int]:
    if onehot <= 0 or onehot & (onehot - 1):
        return None  # not one-hot
    idx = onehot.bit_length() - 1
    return idx if idx < n_ports else None


@dataclass
class _Pending:
    req: MasterRequest
    remaining: int
    visible_cycle: int     # cycle the request is visible at the slave arbiter
    first_word_cycle: Optional[int] = None
    words_sent: int = 0
    grant_sessions: int = 0


class CrossbarSim:
    """Simulate a batch of master requests through the crossbar.

    Decentralised arbitration: one :class:`WRRArbiter` per slave port, with
    quotas read from the register file (``PKGS_PORT<slave>``). Isolation masks
    come from ``ALLOWED_PORT<master>``.
    """

    def __init__(self, n_ports: int = 4, regfile: Optional[RegisterFile] = None,
                 watchdog: int = 10_000):
        self.n_ports = n_ports
        self.regfile = regfile if regfile is not None else _default_regfile(n_ports)
        self.watchdog = watchdog
        self.requests: List[MasterRequest] = []

    def submit(self, req: MasterRequest) -> None:
        if self.regfile.in_reset(req.master):
            raise RuntimeError(
                f"master port {req.master} is held in reset (register 0x10); "
                "the crossbar port makes no grant decisions during PR (§IV-C)")
        self.requests.append(req)

    # ------------------------------------------------------------------
    def run(self) -> List[TransferResult]:
        """Run all submitted requests to completion; returns per-request results."""
        results: List[TransferResult] = []
        per_slave: Dict[int, List[_Pending]] = {j: [] for j in range(self.n_ports)}

        for req in sorted(self.requests):
            visible = req.cycle + REQ_PIPE_CC
            slave = _onehot_to_index(req.dst_onehot, self.n_ports)
            allowed = self.regfile.allowed_mask(req.master)
            if slave is None or (req.dst_onehot & allowed) == 0:
                # Master port blocks the request; error back + status register.
                completion = visible + 2
                results.append(TransferResult(
                    master=req.master, slave=slave, app_id=req.app_id,
                    submit_cycle=req.cycle, first_word_cycle=None,
                    completion_cycle=completion, words_sent=0,
                    grant_sessions=0, error=ErrorCode.INVALID_DEST))
                self._register_error(req, ErrorCode.INVALID_DEST)
                continue
            per_slave[slave].append(_Pending(req=req, remaining=req.n_words,
                                             visible_cycle=visible))

        for slave, pendings in per_slave.items():
            results.extend(self._run_slave(slave, pendings))

        results.sort(key=lambda r: (r.submit_cycle, r.master))
        self.requests = []
        return results

    # ------------------------------------------------------------------
    def _run_slave(self, slave: int, pendings: List[_Pending]) -> List[TransferResult]:
        results: List[TransferResult] = []
        if not pendings:
            return results
        arb = WRRArbiter(n_ports=self.n_ports,
                         quotas=self.regfile.quota_row(slave))
        active = list(pendings)
        # `arb_start`: the cycle arbitration (2 cc) begins for the next grant.
        arb_start = min(p.visible_cycle for p in active)

        while active:
            # Watchdog: drop requests that waited longer than the watchdog for
            # a grant that would begin strictly after their deadline.
            still: List[_Pending] = []
            for p in active:
                deadline = p.req.cycle + self.watchdog
                if p.visible_cycle <= arb_start and arb_start + ARB_CC > deadline \
                        and p.first_word_cycle is None:
                    results.append(self._finish(p, slave, ErrorCode.GRANT_TIMEOUT,
                                                completion=deadline + 1))
                else:
                    still.append(p)
            active = still
            if not active:
                break

            ready = [p for p in active if p.visible_cycle <= arb_start]
            if not ready:
                arb_start = min(p.visible_cycle for p in active)
                continue

            mask = 0
            for p in ready:
                mask |= 1 << p.req.master
            winner = arb.grant_next(mask)
            assert winner is not None
            pend = next(p for p in ready if p.req.master == winner)

            first_word = arb_start + ARB_CC
            if pend.first_word_cycle is None:
                pend.first_word_cycle = first_word
            pend.grant_sessions += 1

            quota = arb.quotas[winner]
            session_words = pend.remaining if not quota else min(quota, pend.remaining)
            release = first_word + session_words - 1   # bus freed after last word
            pend.words_sent += session_words
            pend.remaining -= session_words
            arb.release()

            if pend.remaining == 0:
                active.remove(pend)
                results.append(self._finish(pend, slave, ErrorCode.OK,
                                            completion=release + STATUS_CC))
            else:
                # Quota preemption: re-assert request, visible REREQ_CC later.
                arb.preemptions += 1
                pend.visible_cycle = release + REREQ_CC

            # Next arbitration may begin after the release is observed and
            # requests re-issued — the paper's additive "+4 cc time-to-grant"
            # for every queued master.
            arb_start = release + REARB_OBSERVE_CC + REREQ_CC
            if active:
                arb_start = max(arb_start,
                                min(p.visible_cycle for p in active))
        return results

    def _finish(self, p: _Pending, slave: int, error: ErrorCode,
                completion: int) -> TransferResult:
        self._register_error(p.req, error)
        return TransferResult(
            master=p.req.master, slave=slave, app_id=p.req.app_id,
            submit_cycle=p.req.cycle, first_word_cycle=p.first_word_cycle,
            completion_cycle=completion, words_sent=p.words_sent,
            grant_sessions=p.grant_sessions, error=error)

    def _register_error(self, req: MasterRequest, error: ErrorCode) -> None:
        # PR regions are ports 1..3 in the prototype (port 0 = AXI-WB bridge).
        if 1 <= req.master <= 3:
            self.regfile.set_pr_error(req.master, int(error))
        self.regfile.set_app_error(req.app_id, int(error))


def _default_regfile(n_ports: int) -> RegisterFile:
    rf = RegisterFile(n_ports=n_ports)
    for m in range(n_ports):
        rf.set_allowed_mask(m, (1 << n_ports) - 1)   # everything allowed
    return rf


# ----------------------------------------------------------------------
# Closed-form latency helpers (§V-E / Fig 6) — used by tests & benchmarks.
# ----------------------------------------------------------------------
def best_case_time_to_grant() -> int:
    return TIME_TO_GRANT_CC                                   # 4 cc


def request_completion_cc(n_words: int = 8) -> int:
    return TIME_TO_GRANT_CC + n_words + STATUS_CC             # 13 cc for 8 words


def worst_case_time_to_grant(n_masters: int, n_words: int = 8) -> int:
    """All ``n_masters`` target the same slave simultaneously; the last-served
    master's time-to-grant.  (§V-E: 28 cc for 3 masters, 8 words.)"""
    per_prev = TIME_TO_GRANT_CC + n_words                     # 12 cc (13th overlaps)
    return per_prev * (n_masters - 1) + TIME_TO_GRANT_CC


def worst_case_completion_cc(n_masters: int, n_words: int = 8) -> int:
    """Fig 6: linear in the number of contending masters (37 cc at 3 masters)."""
    return worst_case_time_to_grant(n_masters, n_words) + n_words + STATUS_CC
