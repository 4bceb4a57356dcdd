"""Per-workload feature-history ring buffer (the time axis' host side).

The reference keeps no history — each tick's deltas are consumed and
dropped (`internal/monitor/monitor.go:317-356` replaces the snapshot
wholesale). The temporal estimator (`kepler_tpu.models.temporal`) needs the
last T ticks of the feature vector per workload, so this buffer accretes
one row per workload per `push()` and materialises right-padded
``[W, T, F]`` windows on demand.

Host-side numpy only: rows are tiny (F=7 f32), the buffer is O(W×T)
bytes, and it lives beside the informer on the node agent — the device
only ever sees the dense padded window. Feature rows are computed with the
same formulas as `models.features.build_features` so a window's last
column equals what the single-tick estimators would have seen.

Not thread-safe by design — single-writer, same contract as the informer
(`docs/developer/power-attribution-guide.md:251-257` in the reference).
"""

from __future__ import annotations

import numpy as np

from kepler_tpu_torch.models.features import NUM_FEATURES
from kepler_tpu_torch.resource.informer import FeatureBatch


def feature_rows(batch: FeatureBatch, dt_s: float) -> np.ndarray:
    """One tick's ``[W, F]`` feature matrix (numpy mirror of build_features)."""
    deltas = np.asarray(batch.cpu_deltas, np.float32)
    w = deltas.shape[0]
    denom = batch.node_cpu_delta
    share = deltas / denom if denom > 0 else np.zeros_like(deltas)
    rate = deltas / dt_s if dt_s > 0 else np.zeros_like(deltas)
    rows = np.empty((w, NUM_FEATURES), np.float32)
    rows[:, 0] = deltas
    rows[:, 1] = share
    rows[:, 2] = batch.usage_ratio
    rows[:, 3] = dt_s
    rows[:, 4] = rate
    rows[:, 5] = 1.0
    rows[:, 6] = np.log1p(max(denom, 0.0))
    return rows


class HistoryBuffer:
    """Fixed-window per-id ring buffer of feature rows.

    ``evict_after``: drop ids not seen for that many pushes (terminated
    workloads; mirrors the informer's set-difference terminated detection).
    """

    def __init__(self, window: int = 32,
                 n_features: int = NUM_FEATURES,
                 evict_after: int = 2) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.n_features = n_features
        self._evict_after = evict_after
        self._tick = 0
        # id → (rows [T, F] ring storage, count, write cursor, last-seen tick)
        self._rows: dict[str, np.ndarray] = {}
        self._count: dict[str, int] = {}
        self._cursor: dict[str, int] = {}
        self._seen: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._rows)

    def push(self, batch: FeatureBatch, dt_s: float) -> None:
        """Append this tick's row for every workload in the batch."""
        rows = feature_rows(batch, dt_s)
        self._tick += 1
        for i, wid in enumerate(batch.ids):
            buf = self._rows.get(wid)
            if buf is None:
                buf = np.zeros((self.window, self.n_features), np.float32)
                self._rows[wid] = buf
                self._count[wid] = 0
                self._cursor[wid] = 0
            buf[self._cursor[wid]] = rows[i]
            self._cursor[wid] = (self._cursor[wid] + 1) % self.window
            self._count[wid] = min(self._count[wid] + 1, self.window)
            self._seen[wid] = self._tick
        if self._evict_after > 0:
            dead = [wid for wid, seen in self._seen.items()
                    if self._tick - seen >= self._evict_after]
            for wid in dead:
                for d in (self._rows, self._count, self._cursor, self._seen):
                    del d[wid]

    def window_arrays(
        self, ids: list[str],
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (features f32 [W, T, F], t_valid bool [W, T]), right-padded.

        Rows are oldest→newest so the last valid position is the current
        tick — the position ``predict_temporal`` pools. Unknown ids yield
        empty (all-invalid) windows.
        """
        w = len(ids)
        feats = np.zeros((w, self.window, self.n_features), np.float32)
        t_valid = np.zeros((w, self.window), bool)
        for i, wid in enumerate(ids):
            n = self._count.get(wid, 0)
            if not n:
                continue
            buf = self._rows[wid]
            cur = self._cursor[wid]
            # unroll the ring: oldest entry sits at the write cursor once full
            ordered = np.roll(buf, -cur, axis=0)[self.window - n:]
            feats[i, :n] = ordered
            t_valid[i, :n] = True
        return feats, t_valid
