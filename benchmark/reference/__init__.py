"""The plain reference that decides ``correct``: NumPy and SciPy only, and
nothing of the program.

Each model is one module, ``reference/<reference>.py``, found by the
configuration's ``reference``.  It gives:

- ``atoms(params, shells, grad)``: its atoms along +z on the
  high-resolution samples, ``(aniso (n_aniso, n_hr), iso (n_iso, n_hr),
  extras)``, for one record a shell (``b`` in s/mm^2; ``G`` in T/m,
  ``Delta``, ``delta`` and ``TE`` in s, or None where the protocol gives no
  timing) and the high-resolution gradients ``grad`` (500, 3); the samples
  are shell-major, 500 a shell (``dictionary.hr_samples``).  A model
  without orientation gives ``aniso`` as a (0, n_hr) array: its
  dictionary's ``aniso`` is then (ndirs, nS, 0), and each voxel's signal a
  mixture of the isotropic atoms alone.
- ``add_extras(D, bvals)`` (optional): what it adds to the built
  dictionary, on the subject's whole protocol.
- ``work(params, n_samples, n_dwi)``: ``{'n_aniso', 'n_iso', 'stages'}``,
  the solve's stages as (rows, atoms) pairs (``portbench/work.py``).
- ``solve(config, D, y, lut, lambdas, want_dwi, q, bvals)``: the voxels'
  answers (``reference/pipeline.py``).

A configuration's ``evaluation`` key holds ``Evaluation.set_config``
settings that the harness applies before ``load_data``; the reference
mirrors each, and refuses any other (``pipeline.SETTINGS``):
``doDirectionalAverage`` (a bool) alone.  With it set, ``solve`` receives
``lut=None``, ``y`` (n, n_shells + 1) the normalised signal averaged over
each shell, ``D`` with ``iso`` and ``aniso`` averaged alike (the other
keys as built), and ``bvals`` the averaged scheme's (0, then each shell's
b); the rows are the mean b0 first, then the shells, keyed by b and
timing, in ascending b, the program's order.  ``work`` then receives
``n_samples = n_shells + 1`` and ``n_dwi = n_shells``, and the least-work
count reads the dictionary once where ``n_aniso`` is 0.
"""
import importlib


def module(name: str):
    """The reference module ``reference/<name>.py`` of a model."""
    return importlib.import_module(f'{__name__}.{name}')
