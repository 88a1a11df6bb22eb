"""Carry a fitted state across packages: the reference's (JAX) centers
and assignment, as numpy arrays, become the port's tensors, so both
packages can start from one state."""
from __future__ import annotations

import numpy as np
import torch


def from_reference(centers_np, assignment_np, *, device):
    """(k, d) centers and (n,) assignment (numpy) -> (f32, int32) tensors
    on ``device``."""
    c = torch.tensor(np.asarray(centers_np, np.float32), device=device)
    a = torch.tensor(np.asarray(assignment_np, np.int32), device=device)
    return c, a
