"""The port's device mesh (amico_tpu_torch.parallel.mesh) on the CPU, the
counterpart of tests/test_sharding.py: a fit over a 2- and a 4-entry CPU
mesh (``make_mesh(n, device='cpu')``) equals the one-device fit bit for bit
for NODDI (fused and ``backend='xla'``), FreeWater and CylinderZeppelinBall
(``'auto'``, whose stagewise solver exits batch-wide over a chunk, and
``'pallas'``), because whole chunks go to the devices round robin with the
one-device chunk boundaries; the port's mesh NODDI fit against the JAX
package's ``make_mesh(4)`` fit; the placements, ``masked_mean``, the mesh's
repr in config.pickle, and ``make_mesh()`` without a card."""
import os
import pickle

import numpy as np
import pytest
import torch

import amico_tpu_torch
from amico_tpu_torch.models import NODDI
from amico_tpu_torch.models.base import BaseModel
from amico_tpu_torch.parallel import (make_mesh, masked_mean, replicated,
                                      shard_tiles, tile_sharding)
from amico_tpu_torch.parallel.dist import host_slab
from amico_tpu_torch.utils.logging import AmicoError

torch.set_num_threads(1)

# tests/test_torch_czb.py's reduced radius grid
REDUCED_RS = np.concatenate(([0.01], np.linspace(0.5, 8.0, 6))) * 1e-6


class Ctx:
    """The slice of Evaluation a model's fit reads: 8-voxel tiles and
    64-voxel chunks, so 200 voxels in ~150 direction tiles make ~20 chunks,
    several for every device of a 4-entry mesh."""

    def __init__(self, y, DIRs, htable, kernels, **cfg):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self._cfg = dict({'tile_size': 8, 'voxels_per_chunk': 64,
                          'device': 'cpu', 'doComputeNRMSE': True}, **cfg)

    def get_config(self, k):
        return self._cfg.get(k)


@pytest.fixture(scope='module')
def problems(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_mesh')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    amico_tpu_torch.set_verbose(0)
    from amico_tpu_torch.testing import (czb_scheme, czb_voxels, demo_czb,
                                         demo_freewater, demo_noddi,
                                         demo_scheme, demo_voxels,
                                         freewater_voxels)
    scheme = demo_scheme()
    noddi, nk, nh = demo_noddi(scheme, kernels_dir=str(d / 'n'))
    fw, fk, fh = demo_freewater(scheme, 'Human', str(d / 'f'))
    czb, ck, ch = demo_czb(czb_scheme(), str(d / 'c'), Rs=REDUCED_RS)
    return {
        'NODDI': (noddi, (*demo_voxels(200, nk, nh, seed=5)[:2], nh, nk)),
        'FreeWater': (fw, (*freewater_voxels(200, fk, fh, seed=11)[:2],
                           fh, fk)),
        'CZB': (czb, (*czb_voxels(200, ck, ch, seed=7)[:2], ch, ck))}


# (model, set_solver arguments, extra config)
CASES = {'noddi_fused': ('NODDI', {}, {}),
         'noddi_xla': ('NODDI', {'backend': 'xla'}, {}),
         'noddi_streamed': ('NODDI', {}, {'max_device_bytes': 1}),
         'freewater': ('FreeWater', {}, {'doSaveCorrectedDWI': True}),
         'czb_auto': ('CZB', {}, {}),
         'czb_pallas': ('CZB', {'backend': 'pallas'}, {})}


def fresh(problems, name, solver):
    model, data = problems[name]
    m = type(model)()
    m.set(**{k: v for k, v in model.get_params().items()
             if k in ('IC_VFs', 'IC_ODs', 'type', 'Rs')})
    m.set_solver(**solver)
    m.scheme = model.scheme
    return m, data


@pytest.mark.parametrize('n_dev', [2, 4])
@pytest.mark.parametrize('case', list(CASES))
def test_mesh_fit_equals_one_device(problems, case, n_dev):
    name, solver, cfg = CASES[case]
    model, data = fresh(problems, name, solver)
    one = model.fit(Ctx(*data, **cfg))
    n_chunks = model._last_fit_timers['n_chunks']
    assert n_chunks > n_dev
    mesh = make_mesh(n_dev, device='cpu')
    got = model.fit(Ctx(*data, mesh=mesh, **cfg))
    assert model._last_fit_timers['n_chunks'] == n_chunks
    assert model._last_fit_devices == list(mesh.devices)
    assert set(got) == set(one)
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    assert np.abs(one['estimates']).sum() > 0


def test_whole_chunks_go_round_robin(problems, monkeypatch):
    """The driver builds the model's constants once for each mesh entry and
    hands chunk i, whole, to entry i % n: the chunks are the one-device
    fit's."""
    run = BaseModel._run_tiled_fit
    factories, chunks = [], []

    def recording(self, evaluation, chunk_fn_for, *args):
        def for_device(device):
            fn = chunk_fn_for(device)
            entry = len(factories)
            factories.append(device)

            def chunk(Y, dirs, valid):
                chunks.append((entry, tuple(Y.shape)))
                return fn(Y, dirs, valid)
            return chunk
        return run(self, evaluation, for_device, *args)

    monkeypatch.setattr(BaseModel, '_run_tiled_fit', recording)
    model, data = fresh(problems, 'FreeWater', {})
    model.fit(Ctx(*data))
    assert len(factories) == 1
    one = [shape for _, shape in chunks]
    factories.clear()
    chunks.clear()
    model.fit(Ctx(*data, mesh=make_mesh(3, device='cpu')))
    assert len(factories) == 3
    assert [shape for _, shape in chunks] == one
    assert [entry for entry, _ in chunks] == [i % 3 for i in range(len(one))]


def test_mesh_fit_matches_jax_mesh(tmp_path):
    """tests/test_sharding.py:29-53's recipe (the JAX package's small NODDI
    on 500 demo voxels over make_mesh(4)) against the port's fit over a
    4-entry CPU mesh on the same KERNELS and voxels, at
    tests/test_torch_noddi_model.py::test_fit_matches_golden's bounds
    (median < 1e-5, p95 < 1e-3; the JAX package resolves 'auto' to its
    stagewise XLA path off the TPU, the port runs K1's twin)."""
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    from amico_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from amico_tpu.testing import demo_noddi, demo_scheme, demo_voxels
    from tests.test_models import EvalStub
    scheme = demo_scheme()
    jax_model, kernels, htable = demo_noddi(scheme, small=True,
                                            kernels_dir=str(tmp_path / 'k'))
    y, DIRs, _ = demo_voxels(500, kernels, htable, seed=0)
    ref = jax_model.fit(EvalStub(y, DIRs, htable, kernels,
                                 mesh=jax_make_mesh(4)))['estimates']
    model = NODDI()
    model.set(IC_VFs=jax_model.IC_VFs, IC_ODs=jax_model.IC_ODs)
    model.set_solver()
    model.scheme = scheme
    got = model.fit(Ctx(y, DIRs, htable, kernels, tile_size=32,
                        voxels_per_chunk=4096,
                        mesh=make_mesh(4, device='cpu')))['estimates']
    err = np.abs(got - np.asarray(ref))
    assert got.shape == (500, 3)
    assert np.median(err) < 1e-5, np.median(err)
    assert np.percentile(err, 95) < 1e-3, np.percentile(err, 95)


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(AmicoError, match='no CUDA card'):
        make_mesh()
    with pytest.raises(AmicoError, match='no CUDA card'):
        make_mesh(1, device='cuda')
    with pytest.raises(AmicoError, match='"cuda" or "cpu"'):
        make_mesh(device='meta')


def test_cpu_mesh_entries_and_repr():
    mesh = make_mesh(3, device='cpu')
    assert mesh.size == 3 and mesh.axis_names == ('data',)
    assert mesh.devices == (torch.device('cpu'),) * 3
    assert make_mesh(device='cpu').size == 1
    assert repr(mesh) == "Mesh(devices=['cpu', 'cpu', 'cpu'], " \
        "axis_names=('data',))"
    with pytest.raises(TypeError, match='does not pickle'):
        pickle.dumps(mesh)


def test_placements():
    """tile_sharding splits the tile axis as dist.host_slab splits voxels;
    replicated copies; shard_tiles returns one list per array."""
    mesh = make_mesh(4, device='cpu')
    v = np.arange(30, dtype=np.float32).reshape(10, 3)
    shards = tile_sharding(mesh).place(v)
    assert [s.shape[0] for s in shards] == [3, 3, 2, 2]
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s.numpy(), v[host_slab(10, i, 4)])
    copies = replicated(mesh).place(v)
    assert len(copies) == 4
    for c in copies:
        np.testing.assert_array_equal(c.numpy(), v)
    single = shard_tiles(mesh, v)
    assert isinstance(single, list) and len(single) == 4
    a, b = shard_tiles(mesh, v, v[:, 0])
    assert [s.shape for s in b] == [(3,), (3,), (2,), (2,)]


@pytest.mark.parametrize('sharded', [False, True])
def test_masked_mean_matches_numpy(sharded):
    """tests/test_sharding.py::test_masked_mean_collective's data: on a
    tensor, and on 8 shards reduced one by one; against numpy and the JAX
    package's masked_mean."""
    from amico_tpu.parallel.mesh import masked_mean as jax_masked_mean
    v = np.arange(64, dtype=np.float32).reshape(8, 8)
    m = np.ones((8, 8), np.float32)
    m[0, :] = 0
    args = shard_tiles(make_mesh(8, device='cpu'), v, m) if sharded \
        else (torch.from_numpy(v), torch.from_numpy(m))
    got = masked_mean(*args)
    assert got.dim() == 0
    assert float(got) == pytest.approx(float(v[1:].mean()))
    assert float(got) == pytest.approx(float(jax_masked_mean(v, m)))
    assert float(masked_mean(v, np.zeros_like(m))) == 0.0


def test_facade_mesh_config_pickle(tmp_path):
    """The facade's FreeWater fit with doSaveCorrectedDWI over a 2-entry
    CPU mesh: its maps and corrected DWI equal the one-device facade's,
    and config.pickle records the live mesh by its repr."""
    from tests.test_sweep import _make_subject
    os.environ['AMICO_TPU_HOME'] = str(tmp_path / 'home')
    amico_tpu_torch.set_verbose(0)
    _make_subject(tmp_path, 's1', 0)
    mesh = make_mesh(2, device='cpu')
    out = {}
    for key, m in (('one', None), ('mesh', mesh)):
        ev = amico_tpu_torch.Evaluation(str(tmp_path), 's1', device='cpu',
                                        output_path=str(tmp_path / key))
        for k, v in (('tile_size', 32), ('voxels_per_chunk', 64),
                     ('doSaveCorrectedDWI', True), ('mesh', m)):
            ev.set_config(k, v)
        ev.load_data('DWI.nii.gz', 'DWI.scheme')
        ev.set_model('FreeWater')
        ev.generate_kernels()
        ev.load_kernels()
        ev.fit()
        ev.save_results()
        out[key] = {k: ev.RESULTS[k] for k in ('MAPs', 'DIRs',
                                                'DWI_corrected')}
    assert not ev._signal.value.uploads      # no shared staging on a mesh
    assert ev.model._last_fit_devices == list(mesh.devices)
    for k in out['one']:
        np.testing.assert_array_equal(out['mesh'][k], out['one'][k])
    with open(tmp_path / 'mesh' / 'config.pickle', 'rb') as fid:
        cfg = pickle.load(fid)
    assert cfg['mesh'] == repr(mesh) and 'Mesh' in cfg['mesh']


def test_mesh_config_must_be_a_mesh(problems):
    model, data = fresh(problems, 'FreeWater', {})
    with pytest.raises(AmicoError, match='make_mesh'):
        model.fit(Ctx(*data, mesh='a device mesh'))
