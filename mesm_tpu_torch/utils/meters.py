"""Wall-clock / loss meters (reference utils/data_utils.py:6-31;
mesm_tpu/utils/meters.py)."""
from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.max = -1e10
        self.min = 1e10

    def update(self, val, n: int = 1):
        val = float(val)
        self.max = max(val, self.max)
        self.min = min(val, self.min)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
