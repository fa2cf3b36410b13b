"""Solver helpers shared by the model fits (counterpart of
``amico_tpu.ops.solvers``).  Only ``gram`` is ported so far; the stagewise
``nneg_qp_batch`` is ROADMAP queue 1."""
from __future__ import annotations

import torch


def gram(A: torch.Tensor) -> torch.Tensor:
    """A'A for A (..., m, n), in float32 (TF32 is off, see device.py)."""
    return torch.matmul(A.transpose(-1, -2), A)
