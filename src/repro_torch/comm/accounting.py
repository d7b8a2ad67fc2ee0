"""Communication-volume accounting (paper Sec. V-E), the port's own copy of
``repro.comm.accounting`` (numpy only; the port imports nothing of
``repro``), for the ideal medium: bytes only, no simulated seconds.

The DL rounds report ``round_bytes``; this module accumulates them and
answers 'how many bytes to reach target accuracy X' — the paper's Fig. 7.

Accuracy is only known on rounds where an eval actually ran. Eval-less
rounds carry the last known accuracy for plotting convenience, but
``bytes_to_target`` consults only real-eval rounds, and answers ``None``
for a target the log never measurably crossed.
"""
from __future__ import annotations

import numpy as np


class CommLog:
    def __init__(self):
        self.rounds: list[int] = []
        self.bytes: list[float] = []     # cumulative bytes sent
        self.acc: list[float] = []       # last-known accuracy (plot-friendly)
        self.evaled: list[bool] = []     # True where acc was really measured

    def record(self, rnd: int, round_bytes: float, acc: float | None = None):
        total = (self.bytes[-1] if self.bytes else 0.0) + float(round_bytes)
        self.rounds.append(int(rnd))
        self.bytes.append(total)
        self.evaled.append(acc is not None)
        if acc is not None:
            self.acc.append(float(acc))
        else:
            self.acc.append(self.acc[-1] if self.acc else 0.0)

    def record_bulk(self, rounds, round_bytes):
        """Append a whole engine segment of eval-less rounds at once.

        ``rounds`` / ``round_bytes`` are equal-length arrays (per-round
        values, not cumulative) drained from the segment in one transfer.
        Accuracy backfills the last measured value (``evaled=False``
        throughout), so target queries never credit these rounds.

        Accumulation matches :meth:`record` bit for bit: a sequential
        float64 running sum seeded with the current total.
        """
        rounds = np.asarray(rounds)
        rb = np.asarray(round_bytes, np.float64)
        if rounds.shape != rb.shape:
            raise ValueError("record_bulk arrays must have equal length")
        if rb.size == 0:
            return
        base = self.bytes[-1] if self.bytes else 0.0
        self.rounds.extend(int(r) for r in rounds)
        self.bytes.extend(np.cumsum(np.concatenate([[base], rb]))[1:]
                          .tolist())
        last_acc = self.acc[-1] if self.acc else 0.0
        self.acc.extend([last_acc] * rb.size)
        self.evaled.extend([False] * rb.size)

    def bytes_to_target(self, target_acc: float) -> float | None:
        """Cumulative bytes at the first MEASURED accuracy >= target, else
        None (backfilled eval-less rounds never count)."""
        for b, a, e in zip(self.bytes, self.acc, self.evaled):
            if e and a >= target_acc:
                return b
        return None

    @property
    def total_gb(self) -> float:
        return (self.bytes[-1] / 1e9) if self.bytes else 0.0
