"""Dense id-keyed row store for cumulative accumulators.

Both per-workload energy on the node monitor and per-node energy on the
fleet aggregator need the same thing: ``store[id] += delta`` for tens of
thousands of ids per tick WITHOUT per-row Python. Values live in one f64
``[cap, Z]`` matrix; ids map to rows that persist for the entity's
lifetime (freed on termination); the steady-state update is one cached
gather, one vectorized add, one scatter.
"""

from __future__ import annotations

import numpy as np


class RowStore:
    """Cumulative ``[*, Z]`` accumulators keyed by string ids."""

    def __init__(self, n_zones: int, initial_rows: int = 64) -> None:
        self._z = n_zones
        self.arr = np.zeros((initial_rows, n_zones))
        self.rows: dict[str, int] = {}
        self._free: list[int] = list(range(initial_rows - 1, -1, -1))
        self._cached: tuple[tuple[str, ...], np.ndarray] | None = None

    @property
    def n_zones(self) -> int:
        return self._z

    def __contains__(self, wid: str) -> bool:
        return wid in self.rows

    def row_indices(self, ids: tuple[str, ...]) -> np.ndarray:
        """Row index per id, allocating fresh (zeroed) rows for new ids.
        The index array is cached while the id tuple is unchanged."""
        cached = self._cached
        if cached is not None and cached[0] == ids:
            return cached[1]
        if len(set(ids)) != len(ids):
            # a duplicate id would collapse onto one row and the scatter
            # in accumulate() would drop a delta — fail loudly (not
            # assert: -O must not change energy accounting)
            raise ValueError(
                "duplicate ids in accumulator batch; cumulative energy "
                "accounting requires unique ids")
        idx = np.empty(len(ids), np.intp)
        get = self.rows.get
        for j, wid in enumerate(ids):
            r = get(wid)
            if r is None:
                if not self._free:
                    old_len = len(self.arr)
                    grow = max(old_len, 64)
                    self.arr = np.vstack(
                        [self.arr, np.zeros((grow, self._z))])
                    self._free = list(
                        range(old_len + grow - 1, old_len - 1, -1))
                r = self._free.pop()
                self.arr[r] = 0.0
                self.rows[wid] = r
            idx[j] = r
        self._cached = (ids, idx)
        return idx

    def accumulate(self, ids: tuple[str, ...],
                   deltas: np.ndarray) -> np.ndarray:
        """arr[ids] += deltas; → the new cumulative values [n, Z]."""
        idx = self.row_indices(ids)
        vals = self.arr[idx] + deltas
        self.arr[idx] = vals
        return vals

    def value(self, wid: str) -> np.ndarray:
        return self.arr[self.rows[wid]]

    def pop(self, wid: str) -> None:
        r = self.rows.pop(wid, None)
        if r is not None:
            self._free.append(r)
            self._cached = None

    def remap_columns(self, old_names: list[str],
                      new_names: list[str]) -> None:
        """Re-key the value columns by NAME onto a new axis (zones newly
        appearing start at zero, vanished ones are dropped). Used by the
        fleet aggregator when the canonical zone union changes."""
        old_arr = self.arr
        nz = len(new_names)
        arr = np.zeros((max(len(old_arr), 64), nz))
        old_idx = {zn: j for j, zn in enumerate(old_names)}
        for j, zn in enumerate(new_names):
            oj = old_idx.get(zn)
            if oj is not None and len(old_arr):
                arr[:len(old_arr), j] = old_arr[:, oj]
        self._z = nz
        self.arr = arr
        used = set(self.rows.values())
        self._free = [r for r in range(len(arr) - 1, -1, -1)
                      if r not in used]
        self._cached = None
