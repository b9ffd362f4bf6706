"""Moving-window sub-matrices (counterpart of
``deeplearning4j_tpu/utils/moving_window.py``; reference
MovingWindowMatrix.java: the window_rows x window_cols tiles of a 2-D
matrix, optionally with their 90-degree rotations, for augmenting image
matrices). Host numpy, as in the JAX package."""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["MovingWindowMatrix"]


class MovingWindowMatrix:
    """Every window_rows x window_cols sub-matrix of ``to_slice``, stepping
    by the window size (non-overlapping tiles, as the reference does), with
    optional rotated copies."""

    def __init__(self, to_slice, window_rows: int, window_cols: int,
                 add_rotate: bool = False):
        a = np.asarray(to_slice)
        if a.ndim != 2:
            raise ValueError("MovingWindowMatrix slices 2-D matrices")
        if window_rows < 1 or window_cols < 1:
            raise ValueError("window size must be >= 1")
        if window_rows > a.shape[0] or window_cols > a.shape[1]:
            raise ValueError(
                f"window {window_rows}x{window_cols} exceeds matrix "
                f"{a.shape[0]}x{a.shape[1]}")
        self._a = a
        self.window_rows = window_rows
        self.window_cols = window_cols
        self.add_rotate = add_rotate

    def windows(self, add_rotate: bool = None) -> List[np.ndarray]:
        """The windows, row by row (reference MovingWindowMatrix.windows())."""
        rotate = self.add_rotate if add_rotate is None else add_rotate
        out = []
        for r in range(0, self._a.shape[0] - self.window_rows + 1, self.window_rows):
            for c in range(0, self._a.shape[1] - self.window_cols + 1, self.window_cols):
                w = self._a[r:r + self.window_rows, c:c + self.window_cols]
                out.append(np.array(w))
                if rotate:
                    for k in (1, 2, 3):
                        out.append(np.rot90(w, k))
        return out
