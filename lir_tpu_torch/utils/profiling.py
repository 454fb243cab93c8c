"""Ragged-sweep scheduler counters.

A copy of ``BucketCounters`` and ``OccupancyStats`` from the JAX
package's ``utils/profiling.py``: the scheduler fills them at plan time,
the sweep adds the decode-step occupancy from the early stop's retire
positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class BucketCounters:
    """Per-bucket dispatch accounting for the ragged sweep scheduler."""

    dispatches: int = 0
    cells: int = 0            # real grid cells dispatched in this bucket
    slots: int = 0            # batch rows paid for (incl. padding rows)
    used_slots: int = 0       # batch rows carrying real work
    prompt_tokens: int = 0    # real (unpadded) prefix tokens prefilled
    slot_tokens: int = 0      # prefill rows * bucket_len — token slots paid
    refilled: int = 0         # cells promoted here from a smaller bucket's
                              # ragged tail (slot refill)


@dataclasses.dataclass
class OccupancyStats:
    """Ragged-sweep scheduler counters: per-bucket batch occupancy and
    prompt-padding waste, plus decode-step occupancy from the early-stop
    retire positions.

    - batch occupancy % = real cells / batch slots paid for — slots lost
      to ragged-tail padding rows (slot refill keeps it high).
    - padding waste %  = padded prefix-token slots / total prefix-token
      slots — the prefill's share spent on padding (the bucket ladder
      keeps it low).
    - decode occupancy % = decode steps that produced a live (pre-retire)
      token / decode steps paid for. Rows retired by the early stop idle
      until the batch's slowest row.
    """

    buckets: Dict[int, BucketCounters] = dataclasses.field(
        default_factory=dict)
    grouped_cells: int = 0          # cells scored via a cross-cell prefix group
    grouped_prefill_rows: int = 0   # prefix rows actually prefilled for them
    decode_steps_live: int = 0
    decode_steps_paid: int = 0

    def bucket(self, edge: int) -> BucketCounters:
        return self.buckets.setdefault(int(edge), BucketCounters())

    def add_dispatch(self, edge: int, cells: int, slots: int,
                     prompt_tokens: int, refilled: int = 0,
                     used_slots: Optional[int] = None,
                     prefill_slots: Optional[int] = None) -> None:
        """``slots``/``used_slots`` count batch rows (occupancy);
        ``prefill_slots`` counts rows actually prefilled at this bucket's
        width (padding waste) — they differ in grouped dispatches, where
        member rows outnumber the shared prefix rows."""
        b = self.bucket(edge)
        b.dispatches += 1
        b.cells += cells
        b.slots += slots
        b.used_slots += cells if used_slots is None else used_slots
        b.prompt_tokens += prompt_tokens
        b.slot_tokens += (slots if prefill_slots is None
                          else prefill_slots) * int(edge)
        b.refilled += refilled

    def add_decode(self, steps_live: int, steps_paid: int) -> None:
        self.decode_steps_live += steps_live
        self.decode_steps_paid += steps_paid

    @property
    def occupancy_pct(self) -> float:
        slots = sum(b.slots for b in self.buckets.values())
        used = sum(b.used_slots for b in self.buckets.values())
        return 100.0 * used / slots if slots else 0.0

    @property
    def padding_waste_pct(self) -> float:
        tok = sum(b.prompt_tokens for b in self.buckets.values())
        slot_tok = sum(b.slot_tokens for b in self.buckets.values())
        return 100.0 * (slot_tok - tok) / slot_tok if slot_tok else 0.0

    @property
    def decode_occupancy_pct(self) -> float:
        if not self.decode_steps_paid:
            return 0.0
        return 100.0 * self.decode_steps_live / self.decode_steps_paid

    def summary(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "occupancy_pct": round(self.occupancy_pct, 2),
            "padding_waste_pct": round(self.padding_waste_pct, 2),
            "per_bucket": {
                str(edge): {
                    "dispatches": b.dispatches, "cells": b.cells,
                    "slots": b.slots, "refilled": b.refilled,
                    "padding_waste_pct": round(
                        100.0 * (b.slot_tokens - b.prompt_tokens)
                        / b.slot_tokens, 2) if b.slot_tokens else 0.0,
                }
                for edge, b in sorted(self.buckets.items())
            },
        }
        if self.decode_steps_paid:
            out["decode_occupancy_pct"] = round(self.decode_occupancy_pct, 2)
        if self.grouped_cells:
            out["grouped_cells"] = self.grouped_cells
            out["grouped_prefill_rows"] = self.grouped_prefill_rows
        return out
