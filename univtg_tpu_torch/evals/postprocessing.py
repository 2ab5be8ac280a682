"""Window post-processing pipeline (clip, round-to-multiple, length clamps).

Vectorized numpy rework of eval/postprocessing.py:9-94; the batch-eval path
uses only `round_multiple` (inference clamps to duration beforehand, see
main/inference_mr.py:153,184-192).
"""
from __future__ import annotations

import numpy as np


class WindowPostProcessor:
    def __init__(
        self,
        clip_length=2,
        min_ts_val=0,
        max_ts_val=150,
        min_w_l=2,
        max_w_l=150,
        move_window_method="left",
        process_func_names=("round_multiple",),
    ):
        self.clip_length = clip_length
        self.min_ts_val = min_ts_val
        self.max_ts_val = max_ts_val
        self.min_w_l = min_w_l
        self.max_w_l = max_w_l
        self.move_window_method = move_window_method
        self.process_func_names = process_func_names
        self._fns = {
            "clip_ts": self.clip_min_max_timestamps,
            "round_multiple": self.round_to_multiple_clip_lengths,
            "clip_window_l": self.clip_window_lengths,
        }

    def __call__(self, lines):
        out = []
        for line in lines:
            ws = np.asarray(line["pred_relevant_windows"], dtype=np.float64)
            windows, scores = ws[:, :2], ws[:, 2]
            for name in self.process_func_names:
                windows = self._fns[name](windows)
            line["pred_relevant_windows"] = [
                [float(w[0]), float(w[1]), float(f"{s:.4f}")]
                for w, s in zip(windows, scores)
            ]
            out.append(line)
        return out

    def clip_min_max_timestamps(self, windows):
        return np.clip(windows, self.min_ts_val, self.max_ts_val)

    def round_to_multiple_clip_lengths(self, windows):
        # np.round matches torch.round (banker's rounding) for exact halves.
        return np.round(windows / self.clip_length) * self.clip_length

    def clip_window_lengths(self, windows):
        lengths = windows[:, 1] - windows[:, 0]
        windows = self._move(windows, lengths < self.min_w_l, self.min_w_l)
        windows = self._move(windows, lengths > self.max_w_l, self.max_w_l)
        return windows

    def _move(self, windows, rows, new_length):
        if not np.any(rows):
            return windows
        windows = windows.copy()
        if self.move_window_method == "left":
            windows[rows, 1] = windows[rows, 0] + new_length
        elif self.move_window_method == "right":
            windows[rows, 0] = windows[rows, 1] - new_length
        elif self.move_window_method == "center":
            center = (windows[rows, 0] + windows[rows, 1]) / 2.0
            windows[rows, 0] = center - new_length / 2.0
            windows[rows, 1] = center + new_length / 2.0
        return windows
