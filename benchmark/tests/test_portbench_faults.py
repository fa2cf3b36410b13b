"""A run with the timed path broken underneath comes out as not correct,
once for each fault the cells can have: half of the voxels left out, an
answer altered where it is produced, and (re-fits) the solver's new lambda
not taken.  The exchange between cards does not exist on one card.

NODDI runs on its full atom grid here: the check's median holds a fault
on part of the voxels because the program's own errors have a heavy tail
on that grid (PERF.md); on a 3 x 3 grid they have none."""
import numpy as np
import pytest

from portbench import main

CELLS = ['noddi.refit_up', 'noddi.study', 'freewater.refit',
         'freewater.refit_dwi']


def _run(bench, d, workload, seed):
    """A run long enough that every lambda of a re-fit grid is answered,
    so that what fails it is the fault."""
    r = main.run(bench, workload, seed, 12.0, False, 'cpu', d)
    # three lambdas a re-fit grid; two pool subjects a small study
    assert r['attempted'] >= (2 if workload.endswith('study') else 3)
    return r


def _break_outputs(monkeypatch, how):
    from amico_tpu_torch.models.base import BaseModel
    orig = BaseModel._run_tiled_fit

    def broken(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        for k, v in out.items():
            v = np.array(v)
            if how == 'half':
                v[: v.shape[0] // 2] = 0.0
            else:
                v += 0.05
            out[k] = v
        return out
    monkeypatch.setattr(BaseModel, '_run_tiled_fit', broken)


@pytest.mark.parametrize('workload', CELLS)
@pytest.mark.parametrize('how', ['half', 'altered'])
def test_broken_outputs_are_not_correct(small, monkeypatch, workload, how):
    bench, d = small
    _break_outputs(monkeypatch, how)
    r = _run(bench, d, workload, 4242)
    assert not r['correct'], r['compared']


@pytest.mark.parametrize('workload', ['noddi.refit_up', 'freewater.refit'])
def test_lambda_not_taken_is_not_correct(small, monkeypatch, workload):
    from amico_tpu_torch import models
    bench, d = small
    model = models.NODDI if workload.startswith('noddi') \
        else models.FreeWater
    orig = model.set_solver
    first = {}

    def stale(self, lambda1=None, lambda2=None, **kw):
        if lambda1 is None:
            return orig(self, **kw)
        first.setdefault('lam', (lambda1, lambda2))
        return orig(self, *first['lam'], **kw)
    monkeypatch.setattr(model, 'set_solver', stale)
    r = _run(bench, d, workload, 4243)
    assert not r['correct'], r['compared']
