"""WISHBONE master/slave interface state machines (§IV-F).

The event-driven crossbar simulator (:mod:`repro_torch.core.hw.crossbar`) owns the
*latency arithmetic*; these FSMs model the *protocol behaviour* the paper
describes cycle by cycle — request/grant handshake, stall/ack flow control,
buffer-full back-pressure to the module, watchdog timeouts and the error
codes — so tests can exercise sequences the closed-form model cannot (e.g. a
slave stalling mid-burst, or a module that never drains its buffer).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.hw.crossbar import ErrorCode


class MasterState(enum.Enum):
    IDLE = "idle"
    REQUEST = "request"        # dst presented to crossbar, watchdog running
    SEND = "send"              # granted; one word/cc unless stalled
    WAIT_ACK = "wait_ack"      # all words out, waiting for trailing acks
    STATUS = "status"          # registering transaction error code (1 cc)
    DONE = "done"


@dataclass
class WBMasterIF:
    """§IV-F.1 master interface.

    Drives ``cyc/stb`` (modelled as :attr:`requesting`), watches ``stall`` and
    ``ack`` and gives up via watchdog timers while waiting for a grant or for
    a stalled slave.
    """

    watchdog_grant: int = 64
    watchdog_ack: int = 64
    state: MasterState = MasterState.IDLE
    error: ErrorCode = ErrorCode.OK
    words: List[int] = field(default_factory=list)
    sent: int = 0
    acked: int = 0
    dst_onehot: int = 0
    _wait: int = 0

    def start(self, words: List[int], dst_onehot: int) -> None:
        if self.state not in (MasterState.IDLE, MasterState.DONE):
            raise RuntimeError("master interface busy")
        self.words, self.dst_onehot = list(words), dst_onehot
        self.sent = self.acked = 0
        self.error = ErrorCode.OK
        self._wait = 0
        self.state = MasterState.REQUEST

    @property
    def requesting(self) -> bool:
        return self.state is MasterState.REQUEST

    def step(self, *, grant: bool, stall: bool, ack: bool,
             port_error: bool = False) -> Optional[int]:
        """Advance one clock; returns the data word driven this cycle (if any)."""
        out: Optional[int] = None
        if self.state is MasterState.REQUEST:
            if port_error:                       # isolation violation (§IV-E.2)
                self.error = ErrorCode.INVALID_DEST
                self.state = MasterState.STATUS
            elif grant:
                self.state = MasterState.SEND
            else:
                self._wait += 1
                if self._wait > self.watchdog_grant:
                    self.error = ErrorCode.GRANT_TIMEOUT
                    self.state = MasterState.STATUS
        elif self.state is MasterState.SEND:
            if ack:
                self.acked += 1
            if stall:
                self._wait += 1
                if self._wait > self.watchdog_ack:
                    self.error = ErrorCode.ACK_TIMEOUT
                    self.state = MasterState.STATUS
            else:
                self._wait = 0
                out = self.words[self.sent]
                self.sent += 1
                if self.sent == len(self.words):
                    self.state = (MasterState.WAIT_ACK
                                  if self.acked < len(self.words)
                                  else MasterState.STATUS)
        elif self.state is MasterState.WAIT_ACK:
            if ack:
                self.acked += 1
            if self.acked >= len(self.words):
                self.state = MasterState.STATUS
            else:
                self._wait += 1
                if self._wait > self.watchdog_ack:
                    self.error = ErrorCode.ACK_TIMEOUT
                    self.state = MasterState.STATUS
        elif self.state is MasterState.STATUS:
            self.state = MasterState.DONE        # error code registered this cc
        return out


class SlaveState(enum.Enum):
    IDLE = "idle"
    RECEIVE = "receive"
    STALLED = "stalled"        # registers full, module has not read them


@dataclass
class WBSlaveIF:
    """§IV-F.2 slave interface with ``buffer_words`` data registers."""

    buffer_words: int = 8
    state: SlaveState = SlaveState.IDLE
    regs: List[int] = field(default_factory=list)
    buffer_full: bool = False      # signal to the computation module

    @property
    def stall(self) -> bool:
        return self.state is SlaveState.STALLED

    def module_read(self) -> List[int]:
        """The module drains the registers; slave resumes registering data."""
        data, self.regs = self.regs, []
        self.buffer_full = False
        if self.state is SlaveState.STALLED:
            self.state = SlaveState.RECEIVE
        return data

    def step(self, *, request: bool, word: Optional[int]) -> bool:
        """Advance one clock; returns ``ack`` driven this cycle."""
        if not request:
            # "Whenever the request is de-asserted, the slave interface goes
            # into idle mode" (§IV-F.2).
            self.state = SlaveState.IDLE
            return False
        if self.state is SlaveState.IDLE:
            self.state = SlaveState.RECEIVE
        if self.state is SlaveState.STALLED:
            return False                         # ack de-asserted while full
        if word is None:
            return False
        if len(self.regs) >= self.buffer_words:
            self.state = SlaveState.STALLED
            self.buffer_full = True
            return False
        self.regs.append(word)
        if len(self.regs) == self.buffer_words:
            self.buffer_full = True              # tell the module to read
        return True
