"""Copy of ``amico_tpu/pipeline.py`` for the port, which imports nothing of
``amico_tpu``, with its own :func:`principal_directions` (the OLS DTI fit on
PyTorch) and without the original's ``scatter`` and
``reinstate_corrected_dwi``: the facade scatters the fit's results into
volumes, and reinstates FreeWater's corrected DWI, in torch on the device
that holds the rows (``core.Evaluation._scatter_results``).  Every other
stage is the original's NumPy.

Pure pipeline stages for one fitting run.

The reference folds the whole workflow into the methods of a single
``Evaluation`` object (reference amico/core.py:107-648).  Here every
stage is a free function over plain arrays --

    load -> preprocess -> directions -> fit -> scatter -> save

-- so each step can be called, tested, and jitted on its own.  The
``amico_tpu.core.Evaluation`` facade only wires these together and holds
the config dict; no numerics live there.

Array conventions: 4-D volumes are ``(X, Y, Z, nS) float32``; masked voxel
matrices are ``(N, nS)`` in the volume's float dtype (f32 on the production
path); direction arrays are ``(N, 3) float32``.
"""
from __future__ import annotations

import numpy as np

from .io.scheme import Scheme
from .utils.logging import ERROR, WARNING


# --------------------------------------------------------------------------
# preprocessing stages
# --------------------------------------------------------------------------

def rescale_meaningful(scl_slope: float, scl_inter: float) -> bool:
    """The NIfTI header carries a meaningful intensity transform
    (finite, slope nonzero, not the identity; reference core.py:146-150)."""
    return bool(np.isfinite(scl_slope) and np.isfinite(scl_inter)
                and scl_slope != 0
                and (scl_slope != 1 or scl_inter != 0))


def intensity_rescale(img: np.ndarray, scl_slope: float,
                      scl_inter: float) -> tuple[np.ndarray, bool]:
    """Apply the NIfTI intensity transform ``v*slope + inter`` when the header
    carries a meaningful one (finite, slope nonzero, not the identity).

    Mirrors the load-time rescale of the reference
    (reference amico/core.py:146-150).  Returns ``(image, applied)``.
    """
    if not rescale_meaningful(scl_slope, scl_inter):
        return img, False
    return img * np.float32(scl_slope) + np.float32(scl_inter), True


def finite_report(n_bad: int, fill, stage: str) -> None:
    """Shared error/warning policy for non-finite values found by the fused
    native preprocessing pass -- same messages as :func:`ensure_finite`
    (the substitution itself already happened inside the pass)."""
    if not n_bad:
        return
    if fill is None:
        ERROR(f'Non-finite values found in the {stage} signal -- pass '
              '"replace_bad_voxels" (or raise "b0_min_signal") to load_data() '
              'to handle them')
    WARNING(f'Non-finite values in the {stage} signal; substituting {fill}')


def ensure_finite(img: np.ndarray, fill, stage: str) -> np.ndarray:
    """Guard against NaN/Inf voxels.  ``fill=None`` aborts with a hint; any
    other value is substituted in place (reference core.py:153-158,270-276)."""
    if not (np.isnan(img).any() or np.isinf(img).any()):
        return img
    if fill is None:
        ERROR(f'Non-finite values found in the {stage} signal -- pass '
              '"replace_bad_voxels" (or raise "b0_min_signal") to load_data() '
              'to handle them')
    WARNING(f'Non-finite values in the {stage} signal; substituting {fill}')
    np.nan_to_num(img, copy=False, nan=fill, posinf=fill, neginf=fill)
    return img


def b0_normalize(img: np.ndarray, b0_idx: np.ndarray,
                 b0_min_signal: float) -> tuple[np.ndarray, np.ndarray]:
    """Divide every volume by the voxelwise mean of the b=0 volumes.

    Voxels whose mean b0 falls at or below ``b0_min_signal`` times the mean
    positive b0 are zeroed outright rather than amplified (reference
    core.py:209-223).  Returns ``(normalized image, mean-b0 volume)``.
    """
    mean_b0 = np.mean(img[..., b0_idx], axis=3)
    positive = mean_b0[mean_b0 > 0]
    floor = b0_min_signal * (positive.mean() if positive.size else 0.0)
    weak = mean_b0 <= floor
    inv = np.zeros_like(mean_b0)
    np.divide(1.0, mean_b0, out=inv, where=~weak)
    return img * inv[..., None], mean_b0


def collapse_b0(img: np.ndarray, b0_idx: np.ndarray,
                dwi_idx: np.ndarray) -> np.ndarray:
    """Replace all b=0 volumes with a single averaged one, placed first
    (the ``doMergeB0`` option, reference core.py:225-228)."""
    mean = np.mean(img[..., b0_idx], axis=3, keepdims=True)
    return np.concatenate((mean, img[..., dwi_idx]), axis=3)


def spherical_mean(img: np.ndarray, scheme: Scheme,
                   b0_thr: float) -> tuple[np.ndarray, Scheme]:
    """Per-shell directional average: collapse the 4-D series to one mean b0
    plus one mean volume per shell (ascending b), and build the matching
    synthetic STEJSKALTANNER scheme (reference core.py:232-268).

    This is the mandatory preprocessing for direction-free models (SANDI).
    """
    nsh = len(scheme.shells)
    out = np.empty(img.shape[:3] + (nsh + 1,), dtype=np.float32)
    table = np.zeros((nsh + 1, 7))
    out[..., 0] = np.mean(img[..., scheme.b0_idx], axis=3)
    table[0, 0] = 1.0
    order = np.argsort([s['b'] for s in scheme.shells])
    for k, si in enumerate(order):
        sh = scheme.shells[si]
        out[..., k + 1] = np.mean(img[..., sh['idx']], axis=3)
        table[k + 1] = [1, 0, 0, sh['G'], sh['Delta'], sh['delta'], sh['TE']]
    return out, Scheme(table, b0_thr)


# --------------------------------------------------------------------------
# fit-side stages
# --------------------------------------------------------------------------

def masked_voxels(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Flatten the voxels selected by ``mask`` into an ``(N, nS)`` float
    matrix with negative samples clipped to zero (reference core.py:451-452).
    Voxel order is C order over the mask -- the same order the facade's
    scatter of the results uses.

    The dtype follows the input volume (float32 on the production path):
    every downstream consumer -- the f32 device staging, the f32 DTI fit,
    the corrected-DWI arithmetic -- computes in f32 anyway, and the
    reference's cast to double (core.py:451) bought no accuracy while
    doubling the footprint of a full-brain signal matrix."""
    y = img[mask == 1, :]
    if not np.issubdtype(y.dtype, np.floating):
        y = y.astype(np.float32)
    np.clip(y, 0, None, out=y)
    return y


def principal_directions(y, scheme, method: str, merged_b0: bool,
                         device=None) -> np.ndarray:
    """Per-voxel principal fiber direction, (N, 3) float32 on the host.

    The port's own stage: the DTI fit of :mod:`amico_tpu_torch.ops.dti` by
    ``method`` (OLS, WLS, NLLS or RESTORE).
    ``y`` is an (N, nS) NumPy array (uploaded once, in float32, to
    ``device``, resolved as the ``device`` config key is: None means the
    card, and no card raises) or a tensor already on the device (the
    facade's staged signal, used as it is).  ``merged_b0`` adjusts the
    gradient table for a collapsed-b0 series."""
    import torch

    from .device import resolve_device
    from .ops.dti import fit_dti
    if merged_b0:
        b = np.hstack((0.0, scheme.b[scheme.dwi_idx]))
        g = np.vstack((np.zeros((1, 3)), scheme.raw[scheme.dwi_idx, :3]))
    else:
        b, g = scheme.b, scheme.raw[:, :3]
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(np.asarray(y, np.float32),
                            device=resolve_device(device))
    return fit_dti(y, b, g, method).cpu().numpy().astype(np.float32)


_DTI_METHODS = ('OLS', 'LS', 'WLS', 'NLLS', 'RT', 'RESTORE', 'restore')


def resolve_dti_method(method: str) -> str:
    """Validate and normalize the DTI fit-method name (the reference
    accepts the same set and forwards it to dipy, core.py:414-420).  All
    four families run natively here: OLS/WLS closed-form, NLLS via batched
    Levenberg-Marquardt, RESTORE/RT via robust reweighting
    (amico_tpu.ops.dti)."""
    if method not in _DTI_METHODS:
        ERROR(f'Unknown DTI fit method "{method}"; choose one of '
              f'{", ".join(_DTI_METHODS)}')
    if method in ('RT', 'restore'):
        return 'RESTORE'
    return 'OLS' if method == 'LS' else method


# --------------------------------------------------------------------------
# save stage
# --------------------------------------------------------------------------

def write_map(img_data: np.ndarray, path: str, ref_img, descrip=None,
              cal=(None, None)) -> None:
    """Write one parameter map next to the source geometry: same affine,
    pixdim, and units as the input DWI; fresh intensity scaling; explicit
    display range (reference header plumbing, core.py:548-630)."""
    from .io import nifti
    data = np.asarray(img_data, np.float32)
    img = nifti.Nifti1Image(data, ref_img.affine)
    img.header.pixdim[:] = ref_img.header.pixdim
    img.header.xyzt_units = ref_img.header.xyzt_units
    if descrip is not None:
        img.header.descrip = descrip.encode() if isinstance(descrip, str) else descrip
    lo, hi = cal
    img.header.cal_min = float(lo) if lo is not None else float(data.min())
    img.header.cal_max = float(hi) if hi is not None else float(data.max())
    img.header.scl_slope, img.header.scl_inter = 1.0, 0.0
    nifti.save(img, path)
