"""The benchmark's inputs, made from ``--seed`` on the card with plain torch.

The protocol (with each sample's pulse timing, where its shells give it)
and the mask are fixed by the configuration; the signal of each masked
voxel is drawn from the seed: a sparse mixture of the configuration's own
dictionary atoms (the reference's dictionary is the forward model) at one
of the LUT directions, scaled by S0, with Rician noise.  Every seed gives
the same voxel count and protocol, so the work is the same and only the
values move.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.dictionary import GAMMA

GOLDEN = (1 + 5 ** 0.5) / 2


def hemisphere(n: int, turn: float = 0.0) -> np.ndarray:
    """n spherical-Fibonacci directions on the upper hemisphere, turned
    about z by ``turn`` radians, rounded to 6 decimals (as the scheme file
    holds them)."""
    i = np.arange(n) + 0.5
    z = i / n
    phi = 2 * np.pi * i / GOLDEN + turn
    r = np.sqrt(1 - z * z)
    return np.round(np.stack([r * np.cos(phi), r * np.sin(phi), z], 1), 6)


def _timing(shell: list) -> dict | None:
    """A shell's pulse timing in seconds, ``[b, n, {"Delta": s, "delta":
    s, "TE": s}]`` (TE by default Delta + delta), or None for ``[b, n]``."""
    if len(shell) < 3:
        return None
    t = shell[2]
    Delta, delta = float(t['Delta']), float(t['delta'])
    return {'Delta': Delta, 'delta': delta,
            'TE': float(t.get('TE', Delta + delta))}


def gradient(b: float, Delta: float, delta: float) -> float:
    """G (T/m) of a PGSE pulse pair that gives b (s/mm^2), as AMICO's
    ``sandi2scheme`` derives it."""
    return float(np.sqrt(b * 1e6 / (GAMMA ** 2 * delta ** 2
                                    * (Delta - delta / 3.0))))


def b_values(pulses: np.ndarray) -> np.ndarray:
    """b (s/mm^2) of each (G, Delta, delta, TE) row, as a STEJSKALTANNER
    scheme's reader derives it (AMICO ``scheme.py:79``)."""
    G, Delta, delta = pulses[:, 0], pulses[:, 1], pulses[:, 2]
    return (GAMMA * G * delta) ** 2 * (Delta - delta / 3.0) * 1e-6


def protocol(config: dict):
    """(bvals (nS,), bvecs (nS, 3), pulses (nS, 4) or None): ``blocks``
    blocks, each of an equal share of the b0s and of every shell's
    directions.  Where the shells give their timing, ``pulses`` holds each
    sample's G, Delta, delta and TE (the b0s take the first shell's
    timing), and the b-values are those derived back from it
    (``b_values``), as the program derives them from the scheme; else
    ``pulses`` is None."""
    p = config['protocol']
    blocks = int(p['blocks'])
    shells = [(float(s[0]), hemisphere(int(s[1]), np.pi / GOLDEN * k),
               _timing(s)) for k, s in enumerate(p['shells'])]
    timed = [t is not None for *_, t in shells]
    if any(timed) and not all(timed):
        raise ValueError('every shell of a protocol or none gives its timing')
    bvals, bvecs, pulses = [], [], []
    for blk in range(blocks):
        for _ in range(int(p['b0']) // blocks):
            bvals.append(0.0)
            bvecs.append(np.zeros(3))
            if all(timed):
                t = shells[0][2]
                pulses.append((0.0, t['Delta'], t['delta'], t['TE']))
        for b, dirs, t in shells:
            per = len(dirs) // blocks
            for d in dirs[blk * per:(blk + 1) * per]:
                bvals.append(b)
                bvecs.append(d)
                if t is not None:
                    pulses.append((gradient(b, t['Delta'], t['delta']),
                                   t['Delta'], t['delta'], t['TE']))
    if not all(timed):
        return np.array(bvals), np.array(bvecs), None
    pulses = np.array(pulses)
    return b_values(pulses), np.array(bvecs), pulses


def mask(config: dict) -> np.ndarray:
    """The (X, Y, Z) bool brain mask: a centred ellipsoid."""
    dims = config['protocol']['matrix']
    axes = config['mask']['semi_axes']
    grids = np.meshgrid(*[(np.arange(n) - (n - 1) / 2) / a
                          for n, a in zip(dims, axes)], indexing='ij')
    return sum(g * g for g in grids) <= 1.0


def voxel_signals(config: dict, aniso: torch.Tensor, iso: torch.Tensor,
                  n: int, gen: torch.Generator) -> torch.Tensor:
    """(n, nS) float32 raw signals on the dictionary's device: each a
    mixture of the atoms of ``aniso`` (ndirs, nS, n_aniso) at a random LUT
    direction and of ``iso`` (nS, n_iso), scaled by S0, with Rician
    noise."""
    sig = config['signal']
    dev = aniso.device
    ndirs, nS, n_an = aniso.shape
    na = n_an + iso.shape[1]
    dirs = torch.randint(ndirs, (n,), generator=gen, device=dev)
    W = torch.rand((n, na), generator=gen, device=dev) \
        * (torch.rand((n, na), generator=gen, device=dev)
           < float(sig['density']))
    lead = torch.randint(na, (n,), generator=gen, device=dev)
    W[torch.arange(n, device=dev), lead] += float(sig['lead'])
    W /= W.sum(1, keepdim=True)
    y = W[:, n_an:] @ iso.T
    step = 8192
    for i in range(0, n, step):
        sl = slice(i, min(i + step, n))
        y[sl] += torch.bmm(aniso[dirs[sl]], W[sl, :n_an, None])[..., 0]
    s0 = float(sig['s0'])
    sigma = s0 / float(sig['snr_b0'])
    re = s0 * y + sigma * torch.randn(y.shape, generator=gen, device=dev)
    im = sigma * torch.randn(y.shape, generator=gen, device=dev)
    return torch.sqrt(re * re + im * im)


def subject(config: dict, aniso: torch.Tensor, iso: torch.Tensor,
            seed: int, index: int = 0):
    """One subject from ``seed`` (and its ``index`` in a pool): the volume
    as (nS, Z, Y, X) float32 on the card, which is the NIfTI file's byte
    order, and the masked voxels' raw signals (N, nS) in the C order of the
    (X, Y, Z) mask, which is the order the program's masked gather uses."""
    dev = aniso.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 7919 + index) % (2 ** 63))
    m = mask(config)
    n = int(m.sum())
    y = voxel_signals(config, aniso, iso, n, gen)
    dims = tuple(config['protocol']['matrix'])
    nS = y.shape[1]
    sigma = float(config['signal']['s0']) / float(config['signal']['snr_b0'])
    vol = sigma * torch.randn((int(np.prod(dims)), nS), generator=gen,
                              device=dev).abs_()
    flat = torch.as_tensor(np.flatnonzero(m.ravel()), device=dev)
    vol[flat] = y
    vol = vol.view(dims + (nS,)).permute(3, 2, 1, 0).contiguous()
    return vol, y
