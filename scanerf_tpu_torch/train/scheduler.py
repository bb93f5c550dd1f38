"""Learning-rate schedule (counterpart of ``scanerf_tpu/train/scheduler.py``):
``start * decay_rate**(step / decay_steps)``, with ``decay_steps`` chosen so
that ``end`` is reached at ``iterations``, and 0 outside
[start_itr, end_itr)."""

from __future__ import annotations

import math

import numpy as np


def exp_window_schedule(start_eta: float, end_eta: float, iterations: int,
                        decay_rate: float = 0.1, start_itr: int = 0,
                        end_itr: int = 10**8):
    """step -> learning rate, a float32 computed as the JAX schedule does
    (in float32)."""
    decay_steps = iterations / math.log(end_eta / start_eta, decay_rate)

    def schedule(step) -> float:
        s = np.float32(step)
        eta = np.float32(start_eta) * np.float32(decay_rate) ** (s / np.float32(decay_steps))
        return float(eta) if start_itr <= s < end_itr else 0.0

    return schedule
