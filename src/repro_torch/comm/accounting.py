"""Communication-volume and simulated-time accounting (paper Sec. V-E), the
port's own copy of ``repro.comm.accounting`` (numpy only; the port imports
nothing of ``repro``).

The DL rounds report ``round_bytes`` (and, once network simulation is
ported, a simulated ``round_s``; on the ideal medium it is 0.0, as in the
reference); this module accumulates both and answers 'how many GB /
simulated hours to reach target accuracy X' — the paper's Fig. 7 and its
wall-clock companion.

Accuracy is only known on rounds where an eval actually ran. Eval-less
rounds carry the last known accuracy for plotting convenience, but target
queries (``bytes_to_target`` / ``seconds_to_target``) consult only
real-eval rounds, and both answer ``None`` for a target the log never
measurably crossed.
"""
from __future__ import annotations

import numpy as np


class CommLog:
    def __init__(self):
        self.rounds: list[int] = []
        self.bytes: list[float] = []     # cumulative bytes sent
        self.seconds: list[float] = []   # cumulative simulated wall-clock
        self.acc: list[float] = []       # last-known accuracy (plot-friendly)
        self.evaled: list[bool] = []     # True where acc was really measured

    def record(self, rnd: int, round_bytes: float, acc: float | None = None,
               round_s: float = 0.0):
        total = (self.bytes[-1] if self.bytes else 0.0) + float(round_bytes)
        total_s = (self.seconds[-1] if self.seconds else 0.0) + float(round_s)
        self.rounds.append(int(rnd))
        self.bytes.append(total)
        self.seconds.append(total_s)
        self.evaled.append(acc is not None)
        if acc is not None:
            self.acc.append(float(acc))
        else:
            self.acc.append(self.acc[-1] if self.acc else 0.0)

    def record_bulk(self, rounds, round_bytes, round_s=None):
        """Append a whole engine segment of eval-less rounds at once.

        ``rounds`` / ``round_bytes`` / ``round_s`` are equal-length arrays
        (per-round values, not cumulative) drained from the segment in one
        transfer; ``round_s`` ``None`` is all zeros. Accuracy backfills the
        last measured value (``evaled=False`` throughout), so target
        queries never credit these rounds.

        Accumulation matches :meth:`record` bit for bit: a sequential
        float64 running sum seeded with the current total.
        """
        rounds = np.asarray(rounds)
        rb = np.asarray(round_bytes, np.float64)
        rs = (np.zeros_like(rb) if round_s is None
              else np.asarray(round_s, np.float64))
        if rounds.shape != rb.shape or rb.shape != rs.shape:
            raise ValueError("record_bulk arrays must have equal length")
        if rb.size == 0:
            return
        base_b = self.bytes[-1] if self.bytes else 0.0
        base_s = self.seconds[-1] if self.seconds else 0.0
        self.rounds.extend(int(r) for r in rounds)
        self.bytes.extend(np.cumsum(np.concatenate([[base_b], rb]))[1:]
                          .tolist())
        self.seconds.extend(np.cumsum(np.concatenate([[base_s], rs]))[1:]
                            .tolist())
        last_acc = self.acc[-1] if self.acc else 0.0
        self.acc.extend([last_acc] * rb.size)
        self.evaled.extend([False] * rb.size)

    def _first_crossing(self, target_acc: float) -> int | None:
        for i, (a, e) in enumerate(zip(self.acc, self.evaled)):
            if e and a >= target_acc:
                return i
        return None

    def bytes_to_target(self, target_acc: float) -> float | None:
        """Cumulative bytes at the first MEASURED accuracy >= target, else
        None (backfilled eval-less rounds never count)."""
        i = self._first_crossing(target_acc)
        return None if i is None else self.bytes[i]

    def seconds_to_target(self, target_acc: float) -> float | None:
        """Simulated seconds at the first measured accuracy >= target."""
        i = self._first_crossing(target_acc)
        return None if i is None else self.seconds[i]

    @property
    def total_gb(self) -> float:
        return (self.bytes[-1] / 1e9) if self.bytes else 0.0

    @property
    def total_hours(self) -> float:
        return (self.seconds[-1] / 3600.0) if self.seconds else 0.0
