"""Deterministic fault injection for the serve engine (the port's own copy
of ``repro.serve.faults``, logic unchanged).

A ``FaultPlan`` is a seeded, fully host-side schedule of faults the engine
and its backends consult at fixed points of each step:

- ``alloc`` — the next lazy page growth raises ``PoolExhausted`` before
  touching the pool, exercising the preempt-on-exhaustion containment path.
- ``nan``  — a chosen slot's logits are overwritten with NaN on the device
  before sampling, so a real non-finite value flows through the real guard
  and quarantine path.
- ``step`` — the decode dispatch is replaced by an ``InjectedFault`` raise
  (nothing advanced, so retrying next step is safe).
- ``delay`` — admission is skipped this step (queued requests wait),
  exercising deadline expiry and stall accounting.

Faults are addressed by ENGINE STEP (``ServeEngine.step_idx`` ticks the
plan once per step), optionally by slot, and stay armed for ``count``
consecutive steps: a drill is a pure function of (plan, traffic), so the
same plan replays the same faults at the same points, and a faulted run's
streams can be held bit-equal to a fault-free run's.

``FaultPlan.parse`` accepts the launcher's ``--inject-fault`` grammar:
comma-separated ``kind@step[/slot][xcount]`` specs, e.g. ``"nan@12/0,
alloc@5x3, step@20"``. ``FaultPlan.random(seed, ...)`` draws the same specs
as the reference's for the same seed (numpy's ``RandomState``), so one plan
drives both packages' engines.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultPlan"]

FAULT_KINDS = ("alloc", "nan", "step", "delay")

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<step>\d+)(?:/(?P<slot>-?\d+))?"
    r"(?:x(?P<count>\d+))?$")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` fires on engine steps ``[step, step +
    count)``; ``slot`` targets one lane (``nan`` only; -1 hits every
    slot)."""
    kind: str
    step: int
    slot: int = -1
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")
        if self.step < 0 or self.count < 1:
            raise ValueError(f"fault needs step >= 0, count >= 1: {self}")

    def active(self, step_idx: int) -> bool:
        return self.step <= step_idx < self.step + self.count

    def spec_str(self) -> str:
        """Round-trips through ``FaultPlan.parse``."""
        out = f"{self.kind}@{self.step}"
        if self.slot != -1:
            out += f"/{self.slot}"
        if self.count != 1:
            out += f"x{self.count}"
        return out


class FaultPlan:
    """A deterministic schedule of ``FaultSpec``s plus a firing log.

    The engine calls ``tick(step_idx)`` once per step; the queries
    (``alloc_fails`` / ``nan_slots`` / ``step_fails`` /
    ``admission_delayed``) answer for the current step and append every
    positive answer to ``fired`` as a ``(step, kind, slot)`` tuple, which
    shows that each injection reached its containment path."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.step_idx = -1                 # before the first tick
        self.fired: List[Tuple[int, str, int]] = []

    @classmethod
    def parse(cls, text: Optional[str]) -> "FaultPlan":
        """Comma-separated ``kind@step[/slot][xcount]``; empty or None
        parses to a plan with no faults."""
        specs = []
        for part in (text or "").split(","):
            part = part.strip()
            if not part:
                continue
            m = _SPEC_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad fault spec {part!r} — want "
                    f"kind@step[/slot][xcount], kind in {FAULT_KINDS}")
            specs.append(FaultSpec(
                m.group("kind"), int(m.group("step")),
                slot=int(m.group("slot") or -1),
                count=int(m.group("count") or 1)))
        return cls(specs)

    @classmethod
    def random(cls, seed: int, n_steps: int, n_slots: int,
               n_faults: int = 4,
               kinds: Sequence[str] = FAULT_KINDS) -> "FaultPlan":
        """Seeded random plan: ``n_faults`` draws of (kind, step, slot,
        count) uniform over ``kinds`` x ``[0, n_steps)`` x ``[0, n_slots)``
        x ``{1, 2}`` (same seed, same drill)."""
        rng = np.random.RandomState(seed)
        specs = [FaultSpec(kinds[int(rng.randint(len(kinds)))],
                           int(rng.randint(max(1, n_steps))),
                           slot=int(rng.randint(max(1, n_slots))),
                           count=int(rng.randint(1, 3)))
                 for _ in range(n_faults)]
        return cls(specs)

    # -- engine hooks ---------------------------------------------------

    def tick(self, step_idx: int) -> None:
        self.step_idx = int(step_idx)

    def _fire(self, kind: str, slot: int = -1) -> None:
        self.fired.append((self.step_idx, kind, slot))

    def _active(self, kind: str) -> List[FaultSpec]:
        return [s for s in self.specs
                if s.kind == kind and s.active(self.step_idx)]

    def alloc_fails(self) -> bool:
        """True: the next pool growth must raise ``PoolExhausted``."""
        hit = bool(self._active("alloc"))
        if hit:
            self._fire("alloc")
        return hit

    def nan_slots(self) -> List[int]:
        """Slots whose logits get NaN-poisoned this call (-1 = all)."""
        slots = sorted({s.slot for s in self._active("nan")})
        for s in slots:
            self._fire("nan", s)
        return slots

    def step_fails(self) -> bool:
        """True: this step's decode dispatch raises ``InjectedFault``."""
        hit = bool(self._active("step"))
        if hit:
            self._fire("step")
        return hit

    def admission_delayed(self) -> bool:
        """True: skip admission this step (queued requests keep waiting)."""
        hit = bool(self._active("delay"))
        if hit:
            self._fire("delay")
        return hit

    def spec_str(self) -> str:
        return ",".join(s.spec_str() for s in self.specs)

    def __repr__(self):
        return f"FaultPlan({self.spec_str()!r}, step={self.step_idx})"
