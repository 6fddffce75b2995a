"""Carrier plans & grids — caller-owned OFDM numerology as index arrays.

Behavioral spec: /root/reference/src/multicarrier/config.rs + grid.rs.
Conventions preserved for output compatibility (docs/ofdm.md:22-60):
unity forward FFT / 1/N inverse; natural bin order internally, signed indices
at the API (bin = idx mod n_fft); DC implicitly null unless opted in.

Design: a plan resolves once (at trace time, in numpy) to dense gather/
scatter index arrays; the per-symbol mapper objects of the reference collapse
into whole-frame vectorized gathers (see ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence, Tuple

import numpy as np


class CarrierPlanError(ValueError):
    pass


@dataclass(frozen=True)
class CarrierPlan:
    """Resource-grid description (ref: multicarrier/config.rs:8-243).

    Signed carrier indices: bin 0 = DC, negatives count down. DC is null
    unless explicitly included.
    """

    n_fft: int
    cp_len: int
    data_carriers: Tuple[int, ...] = ()
    pilot_carriers: Tuple[Tuple[int, complex], ...] = ()
    window_roll_off: int = 0

    # ── builders ────────────────────────────────────────────────────────────

    def with_data_carriers(self, carriers: Sequence[int]) -> "CarrierPlan":
        return replace(self, data_carriers=self.data_carriers + tuple(int(c) for c in carriers))

    def with_pilot_carriers(self, carriers) -> "CarrierPlan":
        new = tuple((int(i), complex(v)) for i, v in carriers)
        return replace(self, pilot_carriers=self.pilot_carriers + new)

    def with_window_roll_off(self, roll_off: int) -> "CarrierPlan":
        return replace(self, window_roll_off=int(roll_off))

    def with_contiguous_data(self, edge_guard: int = 0, include_dc: bool = False) -> "CarrierPlan":
        """Contiguous data span leaving ``edge_guard`` nulls per edge
        (ref: config.rs:117-143) — the edge-guard OOB lever."""
        lo, hi = self.index_bounds()
        g = int(edge_guard)
        start = lo + 1 + g
        pilots = {i for i, _ in self.pilot_carriers}
        span = [i for i in range(start, hi - g + 1)
                if not (i == 0 and not include_dc) and i not in pilots]
        return replace(self, data_carriers=self.data_carriers + tuple(span))

    # ── queries ─────────────────────────────────────────────────────────────

    def index_bounds(self) -> Tuple[int, int]:
        n = self.n_fft
        return (-(n // 2), (n - 1) // 2)

    def occupied_half_carriers(self) -> int:
        idx = [abs(i) for i in self.data_carriers] + [abs(i) for i, _ in self.pilot_carriers]
        return max(idx) if idx else 0

    def num_data_carriers(self) -> int:
        return len(self.data_carriers)

    # ── validation ──────────────────────────────────────────────────────────

    def validate(self) -> None:
        if not self.data_carriers:
            raise CarrierPlanError("no data carriers specified")
        lo, hi = self.index_bounds()
        for idx in list(self.data_carriers) + [i for i, _ in self.pilot_carriers]:
            if not (lo <= idx <= hi):
                raise CarrierPlanError(
                    f"carrier index {idx} out of range for n_fft={self.n_fft} "
                    f"(valid: {lo}..={hi})")
        seen = set()
        for idx in list(self.data_carriers) + [i for i, _ in self.pilot_carriers]:
            if idx in seen:
                raise CarrierPlanError(f"carrier index {idx} assigned more than one role")
            seen.add(idx)

    def validate_edge_guard(self, edge_guard: int) -> None:
        self.validate()
        lo, hi = self.index_bounds()
        g = int(edge_guard)
        for idx in list(self.data_carriers) + [i for i, _ in self.pilot_carriers]:
            if idx < lo + g or idx > hi - g:
                raise CarrierPlanError(
                    f"carrier index {idx} intrudes into the {edge_guard}-carrier edge guard")


class CarrierGrid:
    """Signed-index → FFT-bin resolution, done once (ref: multicarrier/grid.rs:18-101).

    The single validation choke point: raises CarrierPlanError on an invalid
    plan. Exposes numpy index arrays consumed by the vectorized grid ops.
    """

    def __init__(self, plan: CarrierPlan):
        plan.validate()
        self.plan = plan
        self.n_fft = plan.n_fft
        self.cp_len = plan.cp_len
        self.data_bins = np.array(
            [i % self.n_fft for i in plan.data_carriers], dtype=np.int32)
        self.pilot_bins = np.array(
            [i % self.n_fft for i, _ in plan.pilot_carriers], dtype=np.int32)
        self.pilot_values = np.array(
            [v for _, v in plan.pilot_carriers], dtype=np.complex64)

    def __repr__(self) -> str:
        # stable across instances of the same plan — cjit uses repr as the
        # static cache key for unhashable arguments
        return f"CarrierGrid({self.plan!r})"

    @property
    def num_data_carriers(self) -> int:
        return len(self.data_bins)

    def symbol_len(self) -> int:
        return self.n_fft + self.cp_len
