"""The port's tile driver (``BaseModel._run_tiled_fit``) in both staging
modes and with mid-fit checkpoints, on the plain twins (device='cpu'):
the signal gathered on the device and the host-tiled chunks streamed beyond
``max_device_bytes`` give equal maps; the checkpoint cases of
tests/test_sweep.py (a matching file is merged, a stale one ignored, the
file deleted at the end); a fit raised mid-way resumes to the
uninterrupted maps; and the facade's staging rule."""
import os

import numpy as np
import pytest
import torch

import amico_tpu_torch
from amico_tpu_torch.models.engine import build_tile_plan, tile_voxels
from amico_tpu_torch import lut as _lut

torch.set_num_threads(1)


class Ctx:
    """The slice of Evaluation a model's fit reads (tests/test_staging.py's
    recipe: 32-voxel tiles, 1,024-voxel chunks), on the CPU."""

    def __init__(self, y, DIRs, htable, kernels, **cfg):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self._cfg = dict({'tile_size': 32, 'voxels_per_chunk': 1024,
                          'device': 'cpu'}, **cfg)

    def get_config(self, k):
        return self._cfg.get(k)


@pytest.fixture(scope='module')
def problems(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_staging')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    amico_tpu_torch.set_verbose(0)
    from amico_tpu_torch.testing import (demo_freewater, demo_noddi,
                                         demo_scheme, demo_voxels,
                                         freewater_voxels)
    scheme = demo_scheme()
    model, kernels, htable = demo_noddi(scheme, kernels_dir=str(d / 'n'))
    y, DIRs, _ = demo_voxels(300, kernels, htable, seed=7)
    fw, fw_kernels, fw_htable = demo_freewater(scheme, 'Human', str(d / 'f'))
    fy, fDIRs, _, _ = freewater_voxels(400, fw_kernels, fw_htable, seed=11)
    return {'NODDI': (model, (y, DIRs, htable, kernels)),
            'FreeWater': (fw, (fy, fDIRs, fw_htable, fw_kernels))}


def fresh(model):
    m = type(model)()
    m.set(**{k: v for k, v in model.get_params().items()
             if k in ('IC_VFs', 'IC_ODs', 'type')})
    m.set_solver()
    m.scheme = model.scheme
    return m


@pytest.mark.parametrize('name', ['NODDI', 'FreeWater'])
def test_gather_and_stream_agree(problems, name):
    """A 1-byte budget streams host-tiled chunks; the maps equal the
    gathered fit's bit for bit, in the same chunks."""
    model, data = problems[name]
    m = fresh(model)
    est = m.fit(Ctx(*data, doComputeNRMSE=True))
    assert m._last_fit_timers['streamed'] == 0
    streamed = m.fit(Ctx(*data, doComputeNRMSE=True, max_device_bytes=1))
    assert m._last_fit_timers['streamed'] == 1
    for k in est:
        np.testing.assert_array_equal(est[k], streamed[k])
    assert np.abs(est['estimates']).sum() > 0


def test_budget_flip_between_fits(problems):
    """tests/test_staging.py:47: lowering max_device_bytes between fits on
    one model instance and one y object switches mode, with equal maps."""
    model, data = problems['NODDI']
    ctx = Ctx(*data)
    est_gather = model.fit(ctx)['estimates']
    ctx._cfg['max_device_bytes'] = 1
    est_stream = model.fit(ctx)['estimates']
    assert model._last_fit_timers['streamed'] == 1
    ctx._cfg['max_device_bytes'] = None
    est_back = model.fit(ctx)['estimates']
    assert model._last_fit_timers['streamed'] == 0
    np.testing.assert_array_equal(est_gather, est_stream)
    np.testing.assert_array_equal(est_gather, est_back)


@pytest.fixture
def ck_setup(problems, tmp_path):
    """tests/test_sweep.py::test_fit_checkpoint_resume's set-up on the
    port's FreeWater: 32-voxel tiles, 128-voxel chunks."""
    model, (y, DIRs, htable, kernels) = problems['FreeWater']
    model = fresh(model)
    ck = str(tmp_path / 'fit_ckpt.npz')

    def ctx(**cfg):
        return Ctx(y, DIRs, htable, kernels, voxels_per_chunk=128, **cfg)

    ref = model.fit(ctx())['estimates']
    plan = build_tile_plan(_lut.dir_to_lut_idx(DIRs.astype(np.float64),
                                               htable), 32)
    return model, ctx, ck, ref, plan, y


def test_checkpoint_written_merged_and_cleaned(ck_setup):
    model, ctx, ck, ref, plan, y = ck_setup
    done = min(4, plan.n_tiles)
    fp = model._ckpt_fingerprint(plan, 32, np.asarray(y))
    # a checkpointed run completes to the same maps and deletes the file
    np.testing.assert_array_equal(
        model.fit(ctx(fit_checkpoint=ck, checkpoint_every=1))['estimates'],
        ref)
    assert not os.path.exists(ck)
    # a partial checkpoint of the right values resumes to the same maps
    partial = np.zeros((plan.n_tiles, 32, 2), np.float32)
    partial[:done] = tile_voxels(plan, ref)[:done]
    np.savez(ck[:-4], plan_fp=fp, done_until=done, estimates=partial)
    np.testing.assert_array_equal(
        model.fit(ctx(fit_checkpoint=ck))['estimates'], ref)
    assert model._last_fit_timers['n_chunks'] == -(-plan.n_tiles // 4) - 1
    # positive control: a matching checkpoint is merged, not recomputed
    np.savez(ck[:-4], plan_fp=fp, done_until=done,
             estimates=np.full((plan.n_tiles, 32, 2), 7.5, np.float32))
    got = model.fit(ctx(fit_checkpoint=ck))['estimates']
    first = plan.perm[:done * 32]
    first = first[first < plan.n_voxels]
    assert np.all(got[first] == 7.5)
    rest = np.setdiff1d(np.arange(len(ref)), first)
    np.testing.assert_array_equal(got[rest], ref[rest])
    assert not os.path.exists(ck)


def test_checkpoint_mismatches_are_ignored(ck_setup):
    """A stale fingerprint, changed solver parameters, changed signal
    content and a missing output key each make the checkpoint ignored."""
    import copy
    model, ctx, ck, ref, plan, y = ck_setup
    done = min(4, plan.n_tiles)
    fp = model._ckpt_fingerprint(plan, 32, np.asarray(y))
    other = copy.copy(model)
    other.solver_params = dict(model.solver_params, lambda2=0.123)
    fp_other = other._ckpt_fingerprint(plan, 32, np.asarray(y))
    assert not np.array_equal(fp, fp_other)
    y2 = np.asarray(y).copy()
    y2[0, 0] += 1.0
    assert not np.array_equal(fp, model._ckpt_fingerprint(plan, 32, y2))
    poison = np.full((plan.n_tiles, 32, 2), 9.0, np.float32)
    for bad in (dict(plan_fp=fp_other, estimates=poison),
                dict(plan_fp=fp + 1, estimates=poison),
                dict(plan_fp=fp)):
        np.savez(ck[:-4], done_until=done, **bad)
        np.testing.assert_array_equal(
            model.fit(ctx(fit_checkpoint=ck))['estimates'], ref)
        assert model._last_fit_timers['n_chunks'] == -(-plan.n_tiles // 4)
        assert not os.path.exists(ck)


@pytest.mark.parametrize('budget', [None, 1])
def test_crash_then_resume(ck_setup, budget):
    """A fit raised from its third chunk (checkpoint_every=1) leaves the
    first two chunks on disk; the rerun resumes there and equals the
    uninterrupted fit, gathered or streamed."""
    model, ctx, ck, ref, plan, y = ck_setup
    run = model._run_tiled_fit

    def crashing(evaluation, fit_chunk_fn, *args):
        calls = []

        def chunk(*a):
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError('injected crash')
            return fit_chunk_fn(*a)
        return run(evaluation, chunk, *args)

    c = ctx(fit_checkpoint=ck, checkpoint_every=1, max_device_bytes=budget)
    model._run_tiled_fit = crashing
    with pytest.raises(RuntimeError, match='injected crash'):
        model.fit(c)
    del model._run_tiled_fit
    with np.load(ck) as f:
        assert int(f['done_until']) == 8
    np.testing.assert_array_equal(model.fit(c)['estimates'], ref)
    assert model._last_fit_timers['n_chunks'] == -(-plan.n_tiles // 4) - 2
    assert not os.path.exists(ck)


@pytest.fixture(scope='module')
def study(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_staging_study')
    from tests.test_dist import make_study
    make_study(str(d / 'study'))
    return str(d / 'study')


def test_facade_staging_rule(study, tmp_path):
    """The facade stages the signal only within max_device_bytes; beyond it
    the DTI fit takes the host array and the driver streams, with equal
    maps and directions.  Its phase timers account for the fit's wall
    time, unattributed_s included."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    ev = amico_tpu_torch.Evaluation(study, 'subj', device='cpu')
    ev.load_data(dwi_filename='DWI.nii.gz', scheme_filename='DWI.scheme')
    ev.set_model('FreeWater')
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    out = []
    for budget in (None, 1024):
        ev.set_config('max_device_bytes', budget)
        ev.fit()
        staged = ev._staged_y_ext_dev
        assert (staged is None) == (budget is not None)
        assert ev.model._last_fit_timers['streamed'] == int(budget is not None)
        tf = ev._last_fit_facade_timers
        parts = sum(v for k, v in tf.items()
                    if k not in ('total_s', 'unattributed_s'))
        assert tf['unattributed_s'] == pytest.approx(tf['total_s'] - parts)
        assert 0.0 <= tf['unattributed_s'] <= tf['total_s']
        out.append((ev.RESULTS['MAPs'].copy(), ev.RESULTS['DIRs'].copy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
