"""Learning-rate scheduling + early stop, host-side (counterpart of
adaptive_tpu/training/schedule.py, the same code).

Reference parity:
* ReduceLROnPlateau x2 with factor 0.5, patience 3, threshold 0.02 (abs,
  'min' mode), min_lr 1e-6 decoder / 1e-7 encoder (train.py:57-60), stepped
  once per epoch on the mean train loss *before* the epoch's batches
  (train.py:93, initial loss 100 at train.py:80).
* early stop: no val-CIDEr improvement in the last patience+1 epochs
  (train.py:243-261).
"""

from __future__ import annotations

from typing import List


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau ('min', threshold_mode='abs',
    cooldown=0) with identical bad-epoch accounting."""

    def __init__(self, lr: float, factor: float = 0.5, patience: int = 3,
                 threshold: float = 0.02, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best - self.threshold:  # 'abs' threshold, 'min' mode
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr


def early_stop_Ornot(cf, cider_scores: List[float], best_cider: float) -> bool:
    """True if the best CIDEr is not within the last patience+1 epochs
    (train.py:243-261)."""
    if cf.train_early_stop and len(cider_scores) > cf.train_early_stop_patience:
        last = cider_scores[-(cf.train_early_stop_patience + 1):]
        if max(last) != best_cider:
            print(
                "No improvement with CIDEr in the last %d epochs...Early stopping triggered."
                % (cf.train_early_stop_patience + 1)
            )
            return True
    return False
