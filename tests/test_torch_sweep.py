"""The port's SubjectSweep (amico_tpu_torch.sweep) on the CPU: the cases of
tests/test_sweep.py (two subjects and a resume, a bad subject, the warm
state, the prefetch pipeline), its maps against the JAX package's
SubjectSweep on the same study, a crash mid-fit resumed from the sweep's
checkpoint, and the multi-host and mesh branches, which raise."""
import os

import numpy as np
import pytest
import torch

import amico_tpu
import amico_tpu_torch
from amico_tpu.io import nifti
from amico_tpu.sweep import SubjectSweep as JaxSubjectSweep
from amico_tpu_torch.models.base import BaseModel
from amico_tpu_torch.sweep import SubjectSweep
from tests.test_sweep import _make_subject
from tests.test_torch_freewater import BOUNDS, assert_close_dist

torch.set_num_threads(1)

CPU = {'tile_size': 32, 'device': 'cpu'}


def fw_map(out):
    return nifti.load(os.path.join(str(out), 'fit_FW.nii.gz')).get_fdata()


@pytest.fixture(scope='module')
def study(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_sweepstudy')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    amico_tpu.set_verbose(0)
    amico_tpu_torch.set_verbose(0)
    for i, name in enumerate(['s1', 's2']):
        _make_subject(d, name, i)
    return d


def test_sweep_two_subjects_and_resume(study):
    """tests/test_sweep.py:39 on the port."""
    sweep = SubjectSweep(str(study), ['s1', 's2'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', config=dict(CPU))
    results = sweep.run()
    for s in ['s1', 's2']:
        out = study / s / 'AMICO' / 'FreeWater'
        assert (out / 'fit_FW.nii.gz').exists()
        assert results[s] == str(out)
        assert not (study / s / '.amico_tpu_ckpt_FreeWater.npz').exists()
    mtime = os.path.getmtime(study / 's1' / 'AMICO' / 'FreeWater'
                             / 'config.pickle')
    sweep2 = SubjectSweep(str(study), ['s1', 's2'], 'FreeWater',
                          dwi_filename='DWI.nii.gz', config=dict(CPU))
    assert sweep2.run(resume=True) == results
    assert os.path.getmtime(
        study / 's1' / 'AMICO' / 'FreeWater' / 'config.pickle') == mtime
    assert sweep2.warm_reused == []


def test_sweep_survives_bad_subject(study):
    """tests/test_sweep.py:57 on the port."""
    sweep = SubjectSweep(str(study), ['nope', 's1'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', config=dict(CPU))
    results = sweep.run()
    assert results['nope'].startswith('FAILED')
    assert not results['s1'].startswith('FAILED')


def test_sweep_warm_state_reuses_model_and_matches_fresh(study):
    """tests/test_sweep.py:193 on the port: the second subject reuses the
    first one's model, KERNELS and htable, and its maps equal a fresh
    sweep's bit for bit."""
    out2 = study / 's2' / 'AMICO' / 'FreeWater'
    warm = SubjectSweep(str(study), ['s1', 's2'], 'FreeWater',
                        dwi_filename='DWI.nii.gz', config=dict(CPU))
    warm.run(resume=False)
    assert warm._warm is not None and warm.warm_reused == ['s2']
    fw_warm = fw_map(out2).copy()
    fresh = SubjectSweep(str(study), ['s2'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', config=dict(CPU))
    fresh.run(resume=False)
    assert fresh.warm_reused == []
    np.testing.assert_array_equal(fw_warm, fw_map(out2))


def test_sweep_prefetch_matches_serial_and_surfaces_failures(tmp_path):
    """tests/test_sweep.py:238 on the port."""
    os.environ.setdefault('AMICO_TPU_HOME', str(tmp_path / 'home'))
    amico_tpu_torch.set_verbose(0)
    subjects = ['p1', 'p2', 'p3']
    for i, name in enumerate(subjects):
        _make_subject(tmp_path, name, 10 + i)
    with open(tmp_path / 'p2' / 'DWI.nii.gz', 'wb') as f:
        f.write(b'not a nifti')
    res = {}
    for pre in (True, False):
        sweep = SubjectSweep(
            str(tmp_path), subjects, 'FreeWater', dwi_filename='DWI.nii.gz',
            config=dict(CPU, prefetch=pre,
                        OUTPUT_path=str(tmp_path / f'out_{pre}')))
        res[pre] = sweep.run(resume=False, checkpoint=False)
    for r in res.values():
        assert set(r) == set(subjects)
        assert str(r['p2']).startswith('FAILED')
    for s in ('p1', 'p3'):
        assert not str(res[True][s]).startswith('FAILED')
        np.testing.assert_array_equal(fw_map(res[True][s]),
                                      fw_map(res[False][s]))


def test_sweep_maps_match_jax(study, tmp_path):
    """The port's sweep against the JAX package's on the same two subjects,
    at tests/test_torch_freewater.py's Human bounds; the directions to
    1e-5."""
    outs = {}
    for name, cls, cfg in (('jax', JaxSubjectSweep, {'tile_size': 32}),
                           ('port', SubjectSweep, dict(CPU))):
        cfg['OUTPUT_path'] = str(tmp_path / name)
        outs[name] = cls(str(study), ['s1', 's2'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', config=cfg).run()
    for s in ('s1', 's2'):
        assert_close_dist(fw_map(outs['port'][s]), fw_map(outs['jax'][s]),
                          BOUNDS['Human'], s)
        dirs = [nifti.load(os.path.join(outs[k][s], 'fit_dir.nii.gz'))
                .get_fdata() for k in ('port', 'jax')]
        np.testing.assert_allclose(dirs[0], dirs[1], atol=1e-5)


def test_sweep_crash_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """A fit that raises after its second chunk leaves the sweep's
    checkpoint (.amico_tpu_ckpt_FreeWater.npz in the subject's directory)
    and marks the subject FAILED; the rerun resumes from done_until, writes
    the maps of an uninterrupted sweep bit for bit and deletes the file."""
    os.environ.setdefault('AMICO_TPU_HOME', str(tmp_path / 'home'))
    amico_tpu_torch.set_verbose(0)
    _make_subject(tmp_path, 'c1', 21)
    cfg = dict(CPU, voxels_per_chunk=32, checkpoint_every=1)
    ref = SubjectSweep(str(tmp_path), ['c1'], 'FreeWater',
                       dwi_filename='DWI.nii.gz',
                       config=dict(cfg, OUTPUT_path=str(tmp_path / 'ref')))
    ref.run(checkpoint=False)
    run = BaseModel._run_tiled_fit
    calls = []

    def crashing(self, evaluation, fit_chunk_fn, *args):
        def chunk(*a):
            calls.append(1)
            if len(calls) > 2:
                raise RuntimeError('injected crash')
            return fit_chunk_fn(*a)
        return run(self, evaluation, chunk, *args)

    ck = tmp_path / 'c1' / '.amico_tpu_ckpt_FreeWater.npz'
    monkeypatch.setattr(BaseModel, '_run_tiled_fit', crashing)
    sweep = SubjectSweep(str(tmp_path), ['c1'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', config=dict(cfg))
    assert sweep.run()['c1'].startswith('FAILED: injected crash')
    with np.load(ck) as f:
        assert int(f['done_until']) == 2
    monkeypatch.setattr(BaseModel, '_run_tiled_fit', run)
    sweep = SubjectSweep(str(tmp_path), ['c1'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', config=dict(cfg))
    out = sweep.run()['c1']
    assert not ck.exists()
    np.testing.assert_array_equal(fw_map(out),
                                  fw_map(ref.results['c1']))


@pytest.mark.parametrize('kw', [{'mesh': 'a mesh'},
                                {'config': dict(CPU, mesh='a mesh')},
                                {'config': dict(CPU, distributed=True)}])
def test_sweep_mesh_and_distributed_raise(study, kw):
    sweep = SubjectSweep(str(study), ['s1'], 'FreeWater',
                         dwi_filename='DWI.nii.gz', **kw)
    with pytest.raises(NotImplementedError, match='entry 10'):
        sweep.run(resume=False)
