"""The plain reference that decides ``correct``: NumPy and SciPy only, and
nothing of the program.

Each model is one module, ``reference/<reference>.py``, found by the
configuration's ``reference``.  It gives:

- ``atoms(params, shells, grad)``: its atoms along +z on the
  high-resolution samples, ``(aniso (n_aniso, n_hr), iso (n_iso, n_hr),
  extras)``, for one record a shell (``b`` in s/mm^2; ``G`` in T/m,
  ``Delta``, ``delta`` and ``TE`` in s, or None where the protocol gives no
  timing) and the high-resolution gradients ``grad`` (500, 3); the samples
  are shell-major, 500 a shell (``dictionary.hr_samples``).
- ``add_extras(D, bvals)`` (optional): what it adds to the built
  dictionary.
- ``work(params, n_samples, n_dwi)``: ``{'n_aniso', 'n_iso', 'stages'}``,
  the solve's stages as (rows, atoms) pairs (``portbench/work.py``).
- ``solve(config, D, y, lut, lambdas, want_dwi, q, bvals)``: the voxels'
  answers (``reference/pipeline.py``).
"""
import importlib


def module(name: str):
    """The reference module ``reference/<name>.py`` of a model."""
    return importlib.import_module(f'{__name__}.{name}')
