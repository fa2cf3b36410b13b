"""The least work of a fit's solve, from the configuration's shapes alone.

Whatever kernel computes the solve, it has to read each voxel's signal
once, the dictionary once and write each voxel's outputs once (the maps,
and with the corrected DWI nS floats more), and it has to form at least
one projection ``A'y`` and one Gram-vector product per stage.  The atom
counts and the stages, as (rows, atoms) pairs, are the model's own
(``work`` in ``reference/<reference>.py``).  The dictionary is one matrix
a LUT direction, or one matrix where the model has no anisotropic atom.
A direction-averaged fit (the configuration's ``evaluation`` sets
``doDirectionalAverage``) reads one b0 sample and one a shell.  The count
does not depend on the program, so a later kernel that is renamed, fused
or replaced is held to the same work.
"""
from __future__ import annotations

from reference import dictionary, module, pipeline

from . import synth

# NVIDIA H100 SXM data sheet, 700 W: float32 outside the tensor cores, and
# HBM3 bandwidth
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12


def shapes(config: dict) -> dict:
    p = config['protocol']
    if pipeline.evaluation(config).get('doDirectionalAverage'):
        bvals, _, pulses = synth.protocol(config)
        n_dwi = len(dictionary.shells(bvals, pulses))
        nS = 1 + n_dwi
    else:
        n_dwi = sum(int(shell[1]) for shell in p['shells'])
        nS = int(p['b0']) + n_dwi
    w = module(config['reference']).work(config['model_params'], nS, n_dwi)
    return dict(nS=nS, n_dwi=n_dwi, n_aniso=int(w['n_aniso']),
                n_iso=int(w['n_iso']), stages=list(w['stages']),
                n_maps=len(config['maps']), ndirs=int(config['lut']['ndirs']))


def least_work(config: dict, n_voxels: int, n_fits: int,
               corrected_dwi: bool) -> tuple[float, float]:
    """(operations, bytes) of ``n_fits`` solves of ``n_voxels`` voxels."""
    s = shapes(config)
    na = s['n_aniso'] + s['n_iso']
    flops = sum(2.0 * (rows * atoms + atoms * atoms)
                for rows, atoms in s['stages'])
    out_floats = s['n_maps'] + (s['nS'] if corrected_dwi else 0)
    copies = s['ndirs'] if s['n_aniso'] else 1
    per_fit_bytes = 4.0 * (n_voxels * (s['nS'] + out_floats)
                           + copies * s['nS'] * na)
    return flops * n_voxels * n_fits, per_fit_bytes * n_fits


def least_time(flops: float, nbytes: float) -> tuple[float, str]:
    """The least seconds on one H100 and which bound sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_S
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')
