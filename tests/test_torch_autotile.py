"""The tile driver's 'auto' resolution and result path
(``amico_tpu_torch.models``) on the CPU: ``engine.auto_tile_size`` against
the JAX package's on its own ladder; the H100 ladders the models give it;
``tile_size='auto'`` (128 on the CPU and on the stagewise solver, the
kernel's cost model on a CUDA device) and CylinderZeppelinBall's
``backend='auto'`` (the stagewise solver off CUDA, the tile kernel on it);
the outputs written in voxel order on the device against the host untile
of the streamed, mesh and checkpointed fits, bit for bit; and NODDI and
FreeWater facade fits at widths 64 and 256 against 128."""
import os

import numpy as np
import pytest
import torch

import amico_tpu_torch
from amico_tpu.models.engine import auto_tile_size as jax_auto_tile_size
from amico_tpu_torch.models import (NODDI, CylinderZeppelinBall, FreeWater,
                                    base)
from amico_tpu_torch.models.base import _Plans
from amico_tpu_torch.models.engine import auto_tile_size
from amico_tpu_torch.ops.cuda_qp import qp_geometry
from amico_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

CUDA = torch.device('cuda', 0)      # a device name; no card is touched


def bucket_counts(n_vox, seed=3):
    """tests/test_staging.py::test_auto_tile_size_properties' buckets."""
    rng = np.random.RandomState(seed)
    return np.bincount(rng.randint(0, 500, n_vox), minlength=500)


@pytest.mark.parametrize('n_vox', [50_000, 409_600, 1_000_000])
def test_auto_tile_size_equals_jax_on_its_ladder(n_vox):
    counts = bucket_counts(n_vox)
    got = auto_tile_size(counts)
    assert got == jax_auto_tile_size(counts)
    assert got % 128 == 0 and 128 <= got <= 1024
    # the ladders and overheads of the port's kernels, through both
    for model in (NODDI, FreeWater, CylinderZeppelinBall):
        for c in (0.0, model._tile_step_overhead, 64.0, 1e4):
            assert auto_tile_size(counts, model._tile_widths, c) == \
                jax_auto_tile_size(counts, model._tile_widths, c)


def test_auto_tile_size_full_brain_case():
    """test_staging.py's 896 case (buckets of ~819 voxels), and an empty
    bucket set, as the JAX function answers them."""
    rng = np.random.RandomState(3)
    for n_vox in (50_000, 409_600, 1_000_000):
        rng.randint(0, 500, n_vox)
    counts = np.bincount(rng.randint(0, 500, 409_600), minlength=500)
    assert auto_tile_size(counts) == jax_auto_tile_size(counts) == 896
    empty = np.zeros(0, np.int64)
    assert auto_tile_size(empty) == jax_auto_tile_size(empty)


@pytest.mark.parametrize('model,n', [(NODDI, None), (FreeWater, 11),
                                     (FreeWater, 12),
                                     (CylinderZeppelinBall, 26)])
def test_h100_ladders(model, n):
    """K1 gives a warp to a voxel, 32 warps a tile: its widths are
    multiples of 32.  K2 holds ``groups`` voxels in flight a tile (n = 11,
    12: FreeWater Human and Mouse; 26: CylinderZeppelinBall): its widths
    are multiples of that.  Every ladder is increasing, its overhead
    non-negative, and the width it picks is on it."""
    widths = model._tile_widths
    assert list(widths) == sorted(set(widths)) and widths[0] > 0
    assert model._tile_step_overhead >= 0
    step = 32 if n is None else qp_geometry(n, widths[0], 227 * 1024).groups
    assert all(w % step == 0 for w in widths)
    for n_vox in (2_000, 409_600):
        assert auto_tile_size(bucket_counts(n_vox), widths,
                              model._tile_step_overhead) in widths


class Ctx:
    def __init__(self, y, DIRs, htable, kernels, **cfg):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self._cfg = dict({'device': 'cpu'}, **cfg)

    def get_config(self, k):
        return self._cfg.get(k)


def plan_cache(model, lut_idx):
    return _Plans(np.asarray(lut_idx))


@pytest.mark.parametrize('cls', [NODDI, FreeWater, CylinderZeppelinBall])
def test_tile_size_resolution(cls):
    """'auto' (or None) is 128 on the CPU and on the stagewise solver; on
    the tile kernels on CUDA devices it is auto_tile_size over the
    buckets' sizes on the model's ladder, the counts kept in the plan
    cache; an explicit width wins everywhere."""
    m = cls()
    lut_idx = np.random.RandomState(0).randint(0, 300, 20_000)
    counts = np.unique(lut_idx, return_counts=True)[1]
    want = auto_tile_size(counts, cls._tile_widths, cls._tile_step_overhead)
    for tile in (None, 'auto'):
        pc = plan_cache(m, lut_idx)
        ctx = Ctx(None, None, None, None, tile_size=tile)
        assert m._tile_size(ctx, pc, 'pallas', [torch.device('cpu')]) == 128
        assert m._tile_size(ctx, pc, 'xla', [CUDA]) == 128
        assert m._tile_size(ctx, pc, 'pallas', [CUDA, torch.device('cpu')]) \
            == 128
        assert 'counts' not in vars(pc)
        assert m._tile_size(ctx, pc, 'pallas', [CUDA, CUDA]) == want
        assert np.array_equal(pc.counts, counts)
        pc.counts = np.array([10 ** 6])     # read from the cache
        assert m._tile_size(ctx, pc, 'pallas', [CUDA]) == auto_tile_size(
            pc.counts, cls._tile_widths, cls._tile_step_overhead)
    for dev, backend in ((torch.device('cpu'), 'pallas'), (CUDA, 'pallas'),
                         (CUDA, 'xla')):
        ctx = Ctx(None, None, None, None, tile_size=48)
        assert m._tile_size(ctx, plan_cache(m, lut_idx), backend, [dev]) == 48


def test_czb_backend_on_cuda():
    """CylinderZeppelinBall's 'auto' is the stagewise solver off a CUDA
    card (the JAX package's TPU hint, so that the CPU fits compare like
    with like) and the tile kernel on one; NODDI and FreeWater resolve
    'auto' to the tile kernels everywhere; an explicit backend wins."""
    for cls, cpu, cuda in ((CylinderZeppelinBall, 'xla', 'pallas'),
                           (NODDI, 'pallas', 'pallas'),
                           (FreeWater, 'pallas', 'pallas')):
        m = cls()
        m.set_solver()
        assert m._solver_backend() == cpu
        assert m._solver_backend('cpu') == cpu
        assert m._solver_backend(torch.device('cpu')) == cpu
        assert m._solver_backend('cuda') == cuda
        assert m._solver_backend(CUDA) == cuda
        for backend in ('xla', 'pallas'):
            m.set_solver(backend=backend)
            assert m._solver_backend(CUDA) == backend
            assert m._solver_backend('cpu') == backend


@pytest.fixture(scope='module')
def problems(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_autotile')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    amico_tpu_torch.set_verbose(0)
    from amico_tpu_torch.testing import (demo_freewater, demo_noddi,
                                         demo_scheme, demo_voxels,
                                         freewater_voxels)
    scheme = demo_scheme()
    model, kernels, htable = demo_noddi(scheme, kernels_dir=str(d / 'n'))
    y, DIRs, _ = demo_voxels(300, kernels, htable, seed=7)
    fw, fk, fh = demo_freewater(scheme, 'Human', str(d / 'f'))
    fy, fDIRs, _, _ = freewater_voxels(400, fk, fh, seed=11)
    return {'NODDI': (model, (y, DIRs, htable, kernels)),
            'FreeWater': (fw, (fy, fDIRs, fh, fk))}


def fresh(model):
    m = type(model)()
    m.set(**{k: v for k, v in model.get_params().items()
             if k in ('IC_VFs', 'IC_ODs', 'type')})
    m.set_solver()
    m.scheme = model.scheme
    return m


# outputs beyond the maps: NODDI's x-based errors and modulated maps,
# FreeWater's corrected DWI
EXTRA = {'NODDI': {'doComputeRMSE': True, 'doComputeNRMSE': True,
                   'doSaveModulatedMaps': True},
         'FreeWater': {'doComputeNRMSE': True, 'doSaveCorrectedDWI': True}}
HOST_MODES = {'streamed': {'max_device_bytes': 1},
              'mesh': {'mesh': 'two'},
              'checkpoint': {'fit_checkpoint': 'ck', 'checkpoint_every': 1}}


@pytest.mark.parametrize('mode', sorted(HOST_MODES) + ['crash'])
@pytest.mark.parametrize('name', ['NODDI', 'FreeWater'])
def test_device_untile_equals_host_untile(problems, name, mode, tmp_path,
                                          monkeypatch):
    """Gathered on one device, the outputs are written in voxel order on
    the device and no host untile runs; the streamed, two-device mesh and
    checkpointed fits (and a checkpointed fit raised after two chunks and
    resumed) untile on the host.  Every output of each equals the gathered
    fit's bit for bit (32-voxel tiles, 128-voxel chunks)."""
    model, data = problems[name]
    m = fresh(model)
    calls = []
    untile = base.untile_voxels
    monkeypatch.setattr(base, 'untile_voxels',
                        lambda *a: calls.append(1) or untile(*a))
    cfg = dict(EXTRA[name], tile_size=32, voxels_per_chunk=128)
    ref = m.fit(Ctx(*data, **cfg))
    assert calls == [] and m._last_fit_timers['untile_s'] >= 0
    assert m._last_fit_timers['pull_s'] >= 0
    n = data[0].shape[0]
    assert all(v.shape[0] == n and v.dtype == np.float32
               for v in ref.values())
    extra = {k: v for k, v in HOST_MODES.get(mode, HOST_MODES['checkpoint'])
             .items()}
    if 'mesh' in extra:
        extra['mesh'] = make_mesh(2, device='cpu')
    if 'fit_checkpoint' in extra:
        extra['fit_checkpoint'] = str(tmp_path / 'ck.npz')
    ctx = Ctx(*data, **cfg, **extra)
    if mode == 'crash':
        run = m._run_tiled_fit

        def crashing(evaluation, chunk_fn_for, *args):
            n_calls = []

            def crashing_for(device):
                fit_chunk = chunk_fn_for(device)

                def chunk(*a):
                    n_calls.append(1)
                    if len(n_calls) > 2:
                        raise RuntimeError('injected crash')
                    return fit_chunk(*a)
                return chunk
            return run(evaluation, crashing_for, *args)
        m._run_tiled_fit = crashing
        with pytest.raises(RuntimeError, match='injected crash'):
            m.fit(ctx)
        del m._run_tiled_fit
        assert os.path.isfile(extra['fit_checkpoint'])
    calls.clear()
    got = m.fit(ctx)
    assert len(calls) == len(ref)
    if mode == 'crash':
        assert m._last_fit_timers['n_chunks'] == \
            -(-m._plans.value.by_width[32].n_tiles // 4) - 2
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_checkpoint_at_another_width_is_not_merged(problems, tmp_path):
    """The checkpoint's fingerprint holds the tile width: one written by a
    fit at 32 voxels a tile, raised after two chunks, is not merged into a
    fit at 64 (which runs every chunk and gives the 64-wide maps)."""
    model, data = problems['FreeWater']
    m = fresh(model)
    ck = str(tmp_path / 'ck.npz')
    ref64 = m.fit(Ctx(*data, tile_size=64, voxels_per_chunk=256))
    n_chunks = m._last_fit_timers['n_chunks']
    run = m._run_tiled_fit

    def crashing(evaluation, chunk_fn_for, *args):
        n_calls = []

        def crashing_for(device):
            fit_chunk = chunk_fn_for(device)

            def chunk(*a):
                n_calls.append(1)
                if len(n_calls) > 2:
                    raise RuntimeError('injected crash')
                return fit_chunk(*a)
            return chunk
        return run(evaluation, crashing_for, *args)
    m._run_tiled_fit = crashing
    with pytest.raises(RuntimeError):
        m.fit(Ctx(*data, tile_size=32, voxels_per_chunk=128,
                  fit_checkpoint=ck, checkpoint_every=1))
    del m._run_tiled_fit
    with np.load(ck) as f:
        assert int(f['done_until']) == 8
    got = m.fit(Ctx(*data, tile_size=64, voxels_per_chunk=256,
                    fit_checkpoint=ck, checkpoint_every=1))
    assert m._last_fit_timers['n_chunks'] == n_chunks
    assert m._last_fit_timers['tile_size'] == 64
    np.testing.assert_array_equal(got['estimates'], ref64['estimates'])
    assert not os.path.exists(ck)


# ------------------------------------------- facade fits at other widths
def concentrated_voxels(make, kernels, htable, n_dirs, seed):
    """Voxels of ``make`` (testing.demo_voxels or freewater_voxels) whose
    LUT directions are the ``n_dirs`` most frequent of a large draw: a few
    hundred voxels a direction bucket, so the buckets span several tiles
    at 64 and 128 voxels and one at 256."""
    out = make(150_000, kernels, htable, seed=seed)
    y, lut_idx = out[0], out[2]
    uniq, counts = np.unique(lut_idx, return_counts=True)
    keep = np.isin(lut_idx, uniq[np.argsort(-counts, kind='stable')[:n_dirs]])
    return y[keep]


@pytest.fixture(scope='module')
def facade_studies(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_autotile_facade')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    from amico_tpu_torch.testing import (demo_freewater, demo_noddi,
                                         demo_scheme, demo_voxels,
                                         freewater_voxels, write_demo_subject)
    # bench.py's protocol, on which the FreeWater audit bounds hold
    scheme = demo_scheme(nb0=9, shells=(700.0, 2000.0), ndir=(30, 60))
    studies = {}
    for name, demo, make in (
            ('NODDI', lambda k: demo_noddi(scheme, kernels_dir=k),
             demo_voxels),
            ('FreeWater', lambda k: demo_freewater(scheme, 'Human', k),
             freewater_voxels)):
        _, kernels, htable = demo(str(d / f'k_{name}'))
        y = concentrated_voxels(make, kernels, htable, 6, seed=5)[:1_200]
        study = str(d / name)
        write_demo_subject(os.path.join(study, 'subj'), scheme, y,
                           (y.shape[0], 1, 1))
        studies[name] = study
    return studies


@pytest.mark.parametrize('width', [64, 256])
@pytest.mark.parametrize('name', ['NODDI', 'FreeWater'])
def test_facade_width_against_128(facade_studies, name, width):
    """A facade fit at 64 or 256 voxels a tile against one at 128 on the
    same subject: K1's agreement bounds for NODDI (median < 1e-5, p95 <
    5e-3); K2's for FreeWater (median < 1e-5, p95 < 1e-3, max < 5e-3) and
    its oracle audit (median < 1e-4, p95 < 1e-3, max < 5e-3)."""
    from amico_tpu_torch.testing import freewater_oracle_audit
    ev = amico_tpu_torch.Evaluation(facade_studies[name], 'subj',
                                    device='cpu')
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model(name)
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    maps = {}
    for w in (128, width):
        ev.set_config('tile_size', w)
        ev.fit()
        assert ev.model._last_fit_timers['tile_size'] == w
        maps[w] = ev.RESULTS['MAPs'][ev.niiMASK_img == 1].astype(np.float64)
        if name == 'FreeWater':
            err = freewater_oracle_audit(ev, n=400, seed=0)
            assert np.median(err) < 1e-4 and np.percentile(err, 95) < 1e-3 \
                and err.max() < 5e-3
    plans = ev.model._plans.value.by_width
    assert plans[64 if width == 64 else 128].n_tiles > 6   # several a bucket
    e = np.abs(maps[width] - maps[128])
    assert np.median(e) < 1e-5 and np.percentile(e, 95) < \
        (5e-3 if name == 'NODDI' else 1e-3)
    if name == 'FreeWater':
        assert e.max() < 5e-3
