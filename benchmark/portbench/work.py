"""The least work of a fit's solve, from the configuration's shapes alone.

Whatever kernel computes the solve, it has to read each voxel's signal
once, the dictionary once and write each voxel's outputs once, and it has
to form at least one projection ``A'y`` and one Gram-vector product per
stage.  NODDI has two full stages (the whole dictionary on all samples;
the white-matter atoms on the DWI samples); its debias reuses the first
stage's projection on a data-dependent support, counted as nothing.
FreeWater has one stage; with the corrected DWI it also writes nS floats a
voxel.  The count does not depend on the program, so a later kernel that
is renamed, fused or replaced is held to the same work.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W: float32 outside the tensor cores, and
# HBM3 bandwidth
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12


def shapes(config: dict) -> dict:
    p = config['protocol']
    n_b0 = int(p['b0'])
    n_dwi = sum(int(n) for _, n in p['shells'])
    mp = config['model_params']
    if config['reference'] == 'noddi':
        n_aniso = len(mp['IC_ODs']) * len(mp['IC_VFs'])
        n_iso, n_maps = 1, 3
    else:
        n_aniso, n_iso, n_maps = len(mp['d_perps']), len(mp['d_isos']), 2
    return dict(nS=n_b0 + n_dwi, n_dwi=n_dwi, n_aniso=n_aniso, n_iso=n_iso,
                n_maps=n_maps, ndirs=int(config['lut']['ndirs']))


def least_work(config: dict, n_voxels: int, n_fits: int,
               corrected_dwi: bool) -> tuple[float, float]:
    """(operations, bytes) of ``n_fits`` solves of ``n_voxels`` voxels."""
    s = shapes(config)
    na = s['n_aniso'] + s['n_iso']
    flops = 2.0 * (s['nS'] * na + na * na)
    if config['reference'] == 'noddi':
        flops += 2.0 * (s['n_dwi'] * s['n_aniso'] + s['n_aniso'] ** 2)
    out_floats = s['n_maps'] + (s['nS'] if corrected_dwi else 0)
    per_fit_bytes = 4.0 * (n_voxels * (s['nS'] + out_floats)
                           + s['ndirs'] * s['nS'] * na)
    return flops * n_voxels * n_fits, per_fit_bytes * n_fits


def least_time(flops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds on one H100 and which bound sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_S
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')
