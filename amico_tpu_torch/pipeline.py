"""Pipeline stages of the port.

Every stage but the direction fit is NumPy and is re-used as it is from
``amico_tpu.pipeline`` (re-exported below).  ``principal_directions`` is
the port's own: it runs the OLS DTI fit of :mod:`amico_tpu_torch.ops.dti`
on a host array or on the facade's staged device tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from amico_tpu.pipeline import (  # noqa: F401
    b0_normalize, collapse_b0, ensure_finite, finite_report,
    intensity_rescale, masked_voxels, reinstate_corrected_dwi,
    rescale_meaningful, resolve_dti_method, scatter, spherical_mean,
    write_map)


def principal_directions(y, scheme, method: str, merged_b0: bool,
                         device=None) -> np.ndarray:
    """Per-voxel principal fiber direction, (N, 3) float32 on the host.

    ``y`` is an (N, nS) NumPy array (uploaded once, in float32, to
    ``device``) or a tensor already on the device (the facade's staged
    signal, used as it is).  ``merged_b0`` adjusts the gradient table for a
    collapsed-b0 series."""
    from .ops.dti import fit_dti
    if merged_b0:
        b = np.hstack((0.0, scheme.b[scheme.dwi_idx]))
        g = np.vstack((np.zeros((1, 3)), scheme.raw[scheme.dwi_idx, :3]))
    else:
        b, g = scheme.b, scheme.raw[:, :3]
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    return fit_dti(y, b, g, method).cpu().numpy().astype(np.float32)
