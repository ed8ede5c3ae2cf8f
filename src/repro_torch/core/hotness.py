"""Long-horizon expert hotness estimation (paper §3.5); the port's copy of
the reference's numpy-only estimator.

Per-(layer, expert) counters accumulate router selections within a
time-based update interval ``T_u``; at each interval boundary they fold into
an EMA ``S ← α·S + (1−α)·c`` and reset. Host-side numpy: the counters are
tiny ((L, E) int64) and the estimator must not sit on the token critical
path.
"""
from __future__ import annotations

import numpy as np


def mask_row_counts(counts, row_valid=None) -> np.ndarray:
    """Scrub row-resolved router counts: (L, R, E) → (L, E), dropping rows
    where ``row_valid`` ((R,) bool) is False before the sum. Aggregated
    (L, E) input passes through untouched. The ONE place the vacant-slot /
    padding-row scrub rule lives — every consumer (serving backends, the
    hotness estimator) must come through here."""
    c = np.asarray(counts)
    if c.ndim == 3:
        if row_valid is not None:
            c = c * np.asarray(row_valid, bool)[None, :, None]
        c = c.sum(axis=1)
    return c


class HotnessEstimator:
    def __init__(self, n_layers: int, num_experts: int, alpha: float = 0.8):
        if not (0.0 <= alpha < 1.0):
            raise ValueError("alpha must be in [0, 1)")
        self.alpha = alpha
        self.counts = np.zeros((n_layers, num_experts), np.int64)
        self.scores = np.zeros((n_layers, num_experts), np.float64)
        self.intervals = 0

    def observe(self, counts, row_valid=None) -> None:
        """Accumulate one step's router-selection counts.

        Accepts the aggregated (L, E) form, or the serving engine's
        row-resolved (L, R, E) form with an optional ``row_valid`` (R,)
        bool mask — invalid (vacant-slot / padding) rows are dropped before
        the sum so phantom traffic never reaches the EMA."""
        c = mask_row_counts(counts, row_valid)
        if c.shape != self.counts.shape:
            raise ValueError(f"counts shape {c.shape} != {self.counts.shape}")
        self.counts += c.astype(np.int64)

    def fold(self) -> np.ndarray:
        """Interval boundary: fold counters into the EMA and reset."""
        self.scores = self.alpha * self.scores + (1 - self.alpha) * self.counts
        self.counts[:] = 0
        self.intervals += 1
        return self.scores

    def swap(self, layer: int, e: int, f: int) -> None:
        """Relabel two experts at ``layer``: an expert-parallel ownership
        migration swaps their positions everywhere, and the EMA history
        follows its expert."""
        self.scores[layer, [e, f]] = self.scores[layer, [f, e]]
        self.counts[layer, [e, f]] = self.counts[layer, [f, e]]

    # -- persistence (cold-start priors) ---------------------------------
    def state_dict(self) -> dict:
        """EMA + unfolded counters, serializable with ``np.savez`` (the
        reference's keys, so a file written by either package loads in the
        other)."""
        return {"alpha": np.float64(self.alpha),
                "counts": self.counts.copy(),
                "scores": self.scores.copy(),
                "intervals": np.int64(self.intervals)}

    def load_state(self, state: dict) -> None:
        """Restore a previous run's traffic history. Shapes must match the
        live estimator (a resized model must not inherit stale priors)."""
        scores = np.asarray(state["scores"], np.float64)
        counts = np.asarray(state["counts"], np.int64)
        if scores.shape != self.scores.shape:
            raise ValueError(
                f"hotness state shape {scores.shape} != "
                f"{self.scores.shape}")
        self.scores = scores.copy()
        self.counts = counts.copy()
        self.intervals = int(state.get("intervals", 0))

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    def load(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state({k: z[k] for k in z.files})
