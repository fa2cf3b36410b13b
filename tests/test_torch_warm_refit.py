"""The port's warm re-fit state against the JAX package's.

``amico_tpu`` keeps state across ``fit()`` calls on the same loaded data:
the facade's masked signal (``_fit_y_cache``), its device upload
(``'__y_ext_dev__'``) and its DTI directions (``_fit_dirs_cache``); the
tile driver's LUT quantization and tile plans (``_plan_cache``) and staged
inputs (``_stage_cache``); each model's device constants
(``_prep_cache``).  The port keeps the same in named records
(``amico_tpu_torch.warm``), with the device added to the keys: the
facade's ``_signal`` (the masked signal, its uploads, its directions), the
tile driver's ``_plans`` and ``_staged``, the model's ``_prep``.  Here the
same numpy-seeded subject goes through both packages' facades, and the
same voxels through both packages' models, for NODDI (K1's twin),
FreeWater and CylinderZeppelinBall on ``'pallas'`` (K2's twin) and SANDI;
each cache is read as hit (the same object as before the fit), miss (a
new one) or none, and the port's reading must be the JAX package's.  The
one departure is the device upload: a port fit that does not stage
(beyond ``max_device_bytes``, or on a mesh) keeps no copy of the signal on
a device, and the next staged fit uploads it again, where the JAX facade
keeps its copy throughout.

Warm maps equal the cold ones bit for bit, and the maps after any change
equal a fresh port Evaluation's bit for bit (both on the CPU).  Against the
JAX package's fit the warm maps are held to each model's existing bounds:
NODDI to tests/test_torch_noddi_model.py's fused bounds (median 1e-5, p95
1e-2), FreeWater to tests/test_torch_freewater.py's BOUNDS['Human'],
CylinderZeppelinBall to tests/test_torch_czb.py's BOUNDS, SANDI to
tests/test_torch_sandi.py's facade bounds (fractions median 5e-3, Rsoma
median 0.3 um)."""
import os

import numpy as np
import pytest
import torch

import amico_tpu
import amico_tpu_torch
from amico_tpu.parallel.mesh import make_mesh as jax_make_mesh
from amico_tpu_torch.io import nifti
from amico_tpu_torch.models.base import BaseModel
from amico_tpu_torch.parallel import make_mesh
from tests.test_torch_czb import BOUNDS as CZB_BOUNDS, REDUCED_RS
from tests.test_torch_freewater import BOUNDS as FW_BOUNDS, PROTOCOL

torch.set_num_threads(1)

CPU = torch.device('cpu')
SMALL = dict(IC_VFs=np.linspace(0.3, 0.99, 4),
             IC_ODs=np.array([0.06, 0.3, 0.8]))
N_VOX, DIM = 240, (10, 6, 4)
# explicit, so that both packages tile alike (the JAX package's 'auto' tile
# width follows the backend) and the fits run several chunks
BASE_CONFIG = {'tile_size': 32, 'voxels_per_chunk': 1024}
CACHES = ('y', 'upload', 'dirs', 'lut', 'plan', 'stage', 'prep')


def assert_close_dist(got, ref, bounds, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    for stat, bound in zip((np.median(err), np.percentile(err, 95),
                            err.max()), bounds):
        assert stat < bound, (what, stat, bound)


def noddi_close(got, ref):
    assert_close_dist(got, ref, (1e-5, 1e-2), 'NODDI maps')


def fw_close(got, ref):
    assert_close_dist(got, ref, FW_BOUNDS['Human'], 'FreeWater maps')


def czb_close(got, ref):
    for col, key in ((0, 'v'), (1, 'a'), (2, 'v')):
        assert_close_dist(got[:, col], ref[:, col], CZB_BOUNDS[key],
                          f'CZB map {col}')


def sandi_close(got, ref):
    d = np.abs(got - ref)
    assert np.median(d[:, :3]) < 5e-3 and np.median(d[:, 3]) < 0.3


# per model: the facade's model name, its parameters, the config set before
# load_data, each package's backend, the map bounds against the JAX fit
MODELS = {
    'NODDI': ('NODDI', SMALL, {}, None, dict(backend='pallas',
                                             precision='highest'),
              noddi_close),
    'FreeWater': ('FreeWater', None, {}, None, dict(backend='pallas'),
                  fw_close),
    'CZB-pallas': ('CylinderZeppelinBall', dict(Rs=REDUCED_RS), {},
                   'pallas', dict(backend='pallas'), czb_close),
    'SANDI': ('SANDI', None, {'doDirectionalAverage': True}, None, {},
              sandi_close),
}


def write_subject(name, study):
    """The model's numpy-seeded subject: N_VOX voxels as DWI.nii."""
    from amico_tpu_torch import testing as t
    kdir = os.path.join(study, 'demo_kernels')
    if name == 'NODDI':
        scheme = t.demo_scheme()
        _, kernels, htable = t.demo_noddi(scheme, kernels_dir=kdir)
        y = t.demo_voxels(N_VOX, kernels, htable, seed=21)[0]
    elif name == 'FreeWater':
        scheme = t.demo_scheme(**PROTOCOL)
        _, kernels, htable = t.demo_freewater(scheme, 'Human', kdir)
        y = t.freewater_voxels(N_VOX, kernels, htable, seed=21)[0]
    elif name == 'CZB-pallas':
        scheme = t.czb_scheme()
        _, kernels, htable = t.demo_czb(scheme, kdir, Rs=REDUCED_RS)
        y = t.czb_voxels(N_VOX, kernels, htable, seed=21)[0]
    else:
        scheme = t.czb_scheme()
        _, kernels, _ = t.demo_sandi(scheme, kdir)
        y = t.sandi_voxels(N_VOX, kernels, seed=21)[0]
    t.write_demo_subject(os.path.join(study, 'subj'), scheme, y, DIM)


def open_eval(pkg, name, study, config):
    """load_data -> set_model -> generate_kernels -> load_kernels with
    ``config`` set first (``mesh`` given as a device count)."""
    model, params, base_cfg, port_backend, jax_solver, _ = MODELS[name]
    port = pkg is amico_tpu_torch
    ev = pkg.Evaluation(study, 'subj', **({'device': 'cpu'} if port else {}))
    for k, v in dict(BASE_CONFIG, **base_cfg, **config).items():
        if k == 'mesh' and v is not None:
            v = make_mesh(v, device='cpu') if port else jax_make_mesh(v)
        ev.set_config(k, v)
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.set_model(model)
    if params:
        ev.model.set(**params)
    if port and port_backend:
        ev.set_solver(backend=port_backend)
    elif not port and jax_solver:
        ev.set_solver(**jax_solver)
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    return ev


def caches(ev):
    """Each cache's current object (None where there is none)."""
    m = ev.model
    if isinstance(ev, amico_tpu_torch.Evaluation):
        sig, plans, prep = ev._signal.value, m._plans.value, m._prep.value
        dirs = sig.dirs.value if sig is not None else None
        return {'y': sig.y if sig is not None else None,
                'upload': sig.uploads.get(CPU) if sig is not None else None,
                'dirs': dirs.DIRs if dirs is not None else None,
                'lut': plans.lut_idx if plans is not None else None,
                'plan': plans.by_width.get(ev.get_config('tile_size'))
                if plans is not None else None,
                'stage': m._staged.value,
                'prep': prep.get(CPU) if prep is not None else None}
    yc = getattr(ev, '_fit_y_cache', None)
    dc = getattr(ev, '_fit_dirs_cache', None)
    pc = getattr(m, '_plan_cache', None)
    prep = getattr(m, '_prep_cache', None)
    return {'y': yc[3] if yc else None,
            'upload': yc[4].get('__y_ext_dev__') if yc else None,
            'dirs': dc[-1] if dc else None, 'lut': pc[1] if pc else None,
            'plan': pc[2].get(ev.get_config('tile_size')) if pc else None,
            'stage': getattr(m, '_stage_cache', None),
            'prep': prep[1] if prep is not None else None}


def reading(before, after):
    return {k: 'none' if after[k] is None
            else 'hit' if after[k] is before[k] else 'miss' for k in after}


class Counts:
    """Calls of the port's cold-fit work while the block runs: the masked
    gather, the signal's upload, the DTI fit, the LUT quantization, the
    tile plan and the model's constants."""

    def __init__(self, model_cls):
        from amico_tpu_torch import core, lut, pipeline
        from amico_tpu_torch.models import base
        from amico_tpu_torch.ops import native
        self.targets = [(native, 'masked_gather_padded'), (core, '_upload'),
                        (pipeline, 'principal_directions'),
                        (lut, 'dir_to_lut_idx'), (base, 'build_tile_plan'),
                        (model_cls, 'prepare')]
        self.n = {}

    def __enter__(self):
        self.saved = [getattr(o, a) for o, a in self.targets]
        for (o, a), f in zip(self.targets, self.saved):
            self.n[a] = 0
            setattr(o, a, self._counting(a, f))
        return self

    def _counting(self, name, f):
        def g(*args, **kw):
            self.n[name] += 1
            return f(*args, **kw)
        return g

    def __exit__(self, *exc):
        for (o, a), f in zip(self.targets, self.saved):
            setattr(o, a, f)


@pytest.fixture(scope='module', params=list(MODELS))
def warm(request, tmp_path_factory):
    """Both facades on the model's subject (one study, so both resample
    the same LUT): a cold fit, then a warm one with the port's cold-fit
    work counted.  Returns the model name, the study, both Evaluations
    and what the warm fits read."""
    name = request.param
    d = tmp_path_factory.mktemp('warm_' + name)
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    study = str(d / 'study')
    write_subject(name, study)
    evs = {pkg: open_eval(pkg, name, study, {})
           for pkg in (amico_tpu_torch, amico_tpu)}
    out = {}
    for pkg, ev in evs.items():
        ev.fit()
        cold = caches(ev)
        maps = ev.RESULTS['MAPs'].copy()
        counts = Counts(type(ev.model))
        if pkg is amico_tpu_torch:
            with counts:
                ev.fit()
        else:
            ev.fit()
        out[pkg] = (reading(cold, caches(ev)), maps, ev.RESULTS['MAPs'],
                    counts.n)
    return name, study, evs, out


def test_warm_refit_reuses_every_cache(warm):
    """The second fit of the same Evaluation reuses every cache the first
    one made, as the JAX package's does, and runs none of the cold-fit
    work; its maps equal the first's bit for bit and stay within the
    model's bounds of the JAX package's."""
    name, _, evs, out = warm
    port, ref = out[amico_tpu_torch], out[amico_tpu]
    assert port[0] == ref[0], (port[0], ref[0])
    want = 'none' if name == 'SANDI' else 'hit'
    assert port[0] == dict({k: 'hit' for k in CACHES}, upload=want,
                           dirs=want, lut=want, plan=want)
    assert port[3] == dict.fromkeys(port[3], 0), port[3]
    np.testing.assert_array_equal(port[2], port[1])
    mask = evs[amico_tpu_torch].niiMASK_img == 1
    MODELS[name][-1](port[2][mask], ref[2][mask])


def fresh_port_maps(name, study, config, edits):
    ev = open_eval(amico_tpu_torch, name, study, config)
    for edit in edits:
        edit(ev)
    ev.fit()
    return ev.RESULTS['MAPs'], ev.RESULTS['DIRs']


def _scale_voxel(ev):
    ev.niiDWI_img[1, 1, 1, :] *= 0.5


def _shrink_mask(ev):
    ev.niiMASK_img[0, 0, 0] = 0


def _move_mask(ev):
    ev.niiMASK_img[0, 0, 0] = 1
    ev.niiMASK_img[0, 0, 1] = 0


def _copy_htable(ev):
    ev.htable = ev.htable.copy()


def _copy_kernels(ev):
    ev.KERNELS = {k: v.copy() if isinstance(v, np.ndarray) else v
                  for k, v in ev.KERNELS.items()}


def _reload(ev):
    ev.load_data(dwi_filename='DWI.nii', scheme_filename='DWI.scheme')
    ev.load_kernels()


# each change in turn: (what, config set, edit of the loaded state); the
# upload's departure from the JAX facade where the fit does not stage
# (JAX keeps its copy: 'hit') and on the staged fit after it
STEPS = (
    ('volume edited in place', {}, _scale_voxel),
    ('mask shrunk in place', {}, _shrink_mask),
    ('mask moved in place (same size)', {}, _move_mask),
    ('DIRs from a peaks file', {'peaks_filename': 'peaks.nii.gz'}, None),
    ('new DIRs from the peaks file again', {}, None),
    ('DTI directions again', {'peaks_filename': None}, None),
    ('new htable', {}, _copy_htable),
    ('new KERNELS', {}, _copy_kernels),
    ('tile size', {'tile_size': 64}, None),
    ('voxels_per_chunk', {'voxels_per_chunk': 512}, None),
    ('mesh', {'mesh': 2}, None),
    ('no mesh', {'mesh': None}, None),
    ('one-card mesh', {'mesh': 1}, None),
    ('no mesh after a one-card mesh', {'mesh': None}, None),
    ('DTI_fit_method', {'DTI_fit_method': 'WLS'}, None),
    ('budget crossed downwards', {'max_device_bytes': 1}, None),
    ('budget crossed upwards', {'max_device_bytes': None}, None),
    ('doMergeB0 (data and kernels reloaded)', {'doMergeB0': True}, _reload),
)
UPLOAD_DEPARTURE = {'mesh': 'none', 'no mesh': 'miss',
                    'one-card mesh': 'none',
                    'no mesh after a one-card mesh': 'miss',
                    'budget crossed downwards': 'none',
                    'budget crossed upwards': 'miss'}


def same_plan(a, b):
    return a is b or (np.array_equal(a.perm, b.perm)
                      and np.array_equal(a.tile_dirs, b.tile_dirs))


def test_invalidation_matches_jax(warm):
    """From the warm state, each change of STEPS on both Evaluations: the
    port's caches hit and miss where the JAX package's do, and its maps and
    directions equal a fresh port Evaluation's in the same state bit for
    bit.  Two departures: the upload (UPLOAD_DEPARTURE), and the staged
    inputs where the JAX driver hits with a plan that changed: its key
    holds a sum of the plan's permutation, which stays the same when new
    directions move voxels between tiles of the same directions (here, on
    the change of DTI_fit_method), and its maps then come from the old
    plan's tiles; the port compares the plan exactly and misses."""
    name, study, evs, _ = warm
    port_ev = evs[amico_tpu_torch]
    peaks = os.path.join(study, 'subj', 'peaks.nii.gz')
    nifti.save(nifti.Nifti1Image(port_ev.RESULTS['DIRs'].astype(np.float32),
                                 np.diag([2.0, 2.0, 2.0, 1.0])), peaks)
    config, edits = {}, []
    for what, cfg, edit in STEPS:
        if name == 'SANDI' and 'peaks_filename' in cfg:
            continue            # a direction-free model reads no peaks
        config.update(cfg)
        got, plans = {}, {}
        for pkg, ev in evs.items():
            before = caches(ev)
            for k, v in cfg.items():
                if k == 'mesh' and v is not None:
                    v = make_mesh(v, device='cpu') if pkg is amico_tpu_torch \
                        else jax_make_mesh(v)
                ev.set_config(k, v)
            if edit is not None:
                edit(ev)
            ev.fit()
            after = caches(ev)
            got[pkg] = reading(before, after)
            plans[pkg] = before['plan'], after['plan']
        want = dict(got[amico_tpu])
        if what in UPLOAD_DEPARTURE and want['upload'] == 'hit':
            want['upload'] = UPLOAD_DEPARTURE[what]
        if want['stage'] == 'hit' and not same_plan(*plans[amico_tpu]):
            want['stage'] = 'miss'      # the JAX key's plan sum departure
        assert got[amico_tpu_torch] == want, (what, got)
        if edit is _reload:
            edits = []
        elif edit is not None:
            edits.append(edit)
        maps, dirs = fresh_port_maps(name, study, config, edits)
        np.testing.assert_array_equal(port_ev.RESULTS['MAPs'], maps,
                                      err_msg=what)
        np.testing.assert_array_equal(port_ev.RESULTS['DIRs'], dirs,
                                      err_msg=what)


# ------------------------------------------- the models' fit(Ctx) caches
class Ctx:
    """The slice of Evaluation a model's fit reads."""

    def __init__(self, y, DIRs, htable, kernels, **config):
        self.y, self.DIRs, self.htable, self.KERNELS = y, DIRs, htable, kernels
        self.config = dict(BASE_CONFIG, **config)

    def get_config(self, key):
        return self.config.get(key)


@pytest.fixture(scope='module')
def problems(tmp_path_factory):
    """Per tile-driven model: KERNELS, htable, 200 voxels and their DIRs,
    and random DIRs for the same voxels."""
    from amico_tpu_torch import testing as t
    d = tmp_path_factory.mktemp('warm_models')
    os.environ['AMICO_TPU_HOME'] = str(d / 'home')
    out = {}
    rng = np.random.RandomState(99)
    for name in ('NODDI', 'FreeWater', 'CZB-pallas'):
        if name == 'NODDI':
            scheme = t.demo_scheme()
            _, kernels, htable = t.demo_noddi(scheme,
                                              kernels_dir=str(d / name))
            y, DIRs, _ = t.demo_voxels(200, kernels, htable, seed=3)
        elif name == 'FreeWater':
            scheme = t.demo_scheme(**PROTOCOL)
            _, kernels, htable = t.demo_freewater(scheme, 'Human',
                                                  str(d / name))
            y, DIRs, _, _ = t.freewater_voxels(200, kernels, htable, seed=3)
        else:
            scheme = t.czb_scheme()
            _, kernels, htable = t.demo_czb(scheme, str(d / name),
                                            Rs=REDUCED_RS)
            y, DIRs, _, _ = t.czb_voxels(200, kernels, htable, seed=3)
        other = rng.randn(200, 3)
        other /= np.linalg.norm(other, axis=1, keepdims=True)
        out[name] = (scheme, kernels, htable, y, DIRs, other)
    return out


def new_model(pkg, name, scheme):
    model_name, params, _, port_backend, _, _ = MODELS[name]
    model = getattr(pkg.models, model_name)()
    if params:
        model.set(**params)
    if pkg is amico_tpu_torch:
        model.set_solver(backend=port_backend)
    else:
        model.set_solver()
    model.scheme = scheme
    return model


def model_caches(model):
    if isinstance(model, BaseModel):
        plans, stage, prep = (model._plans.value, model._staged.value,
                              model._prep.value)
        # the staged flat signal: the driver's own upload (no facade here)
        return {'lut': plans.lut_idx if plans is not None else None,
                'plan': plans.by_width.get(32) if plans is not None
                else None, 'stage': stage,
                'y_ext': stage.signal.get(CPU) if stage is not None
                else None,
                'prep': prep.get(CPU) if prep is not None else None}
    pc = getattr(model, '_plan_cache', None)
    prep = getattr(model, '_prep_cache', None)
    stage = getattr(model, '_stage_cache', None)
    return {'lut': pc[1] if pc else None,
            'plan': pc[2].get(32) if pc else None, 'stage': stage,
            'y_ext': stage[1].get('__y_ext__') if stage is not None
            else None, 'prep': prep[1] if prep is not None else None}


@pytest.mark.parametrize('name', ['NODDI', 'FreeWater', 'CZB-pallas'])
@pytest.mark.parametrize('case', ['warm', 'new DIRs', 'budget flip'])
def test_model_fit_caches_match_jax(problems, name, case):
    """Port counterparts of tests/test_staging.py's
    test_gather_warm_refit_reuses_staged_signal and
    test_budget_flip_between_fits_invalidates_mode_cache and of
    tests/test_review_fixes.py's test_stage_cache_invalidated_by_new_dirs,
    on each model's fit(Ctx) with the same y object: the second fit's
    caches hit and miss as the JAX model's do, and its maps equal a fresh
    port model's bit for bit (new DIRs: and differ from the first fit's)."""
    scheme, kernels, htable, y, DIRs, other = problems[name]
    first = dict(device='cpu')
    second = {'new DIRs': dict(device='cpu', DIRs=other),
              'budget flip': dict(device='cpu', max_device_bytes=1)}.get(
                  case, first)
    got = {}
    for pkg in (amico_tpu_torch, amico_tpu):
        model = new_model(pkg, name, scheme)
        est = model.fit(Ctx(y, DIRs, htable, kernels, **first))['estimates']
        before = model_caches(model)
        cfg = dict(second)
        est2 = model.fit(Ctx(y, cfg.pop('DIRs', DIRs), htable, kernels,
                             **cfg))['estimates']
        got[pkg] = reading(before, model_caches(model))
        if pkg is amico_tpu_torch:
            port, port_est = model, (est, est2)
    assert got[amico_tpu_torch] == got[amico_tpu], got
    want = {'warm': dict.fromkeys(got[amico_tpu], 'hit'),
            'new DIRs': {'lut': 'miss', 'plan': 'miss', 'stage': 'miss',
                         'y_ext': 'miss', 'prep': 'hit'},
            'budget flip': {'lut': 'hit', 'plan': 'hit', 'stage': 'none',
                            'y_ext': 'none', 'prep': 'hit'}}[case]
    assert got[amico_tpu_torch] == want, got
    cfg = dict(second)
    fresh = new_model(amico_tpu_torch, name, scheme).fit(
        Ctx(y, cfg.pop('DIRs', DIRs), htable, kernels, **cfg))['estimates']
    np.testing.assert_array_equal(port_est[1], fresh)
    if case == 'new DIRs':
        assert not np.allclose(port_est[0], port_est[1])
    else:
        np.testing.assert_array_equal(port_est[0], port_est[1])


@pytest.mark.parametrize('case', ['new DIRs', 'budget flip'])
def test_a_miss_frees_the_old_staged_signal_first(problems, case):
    """The device budget keeps its meaning: when a fit misses the staged
    inputs (new directions) or streams (the budget crossed), the staged
    signal of the fit before is freed before the fit's first chunk runs,
    so the two are never held at once."""
    import weakref
    scheme, kernels, htable, y, DIRs, other = problems['FreeWater']
    model = new_model(amico_tpu_torch, 'FreeWater', scheme)
    model.fit(Ctx(y, DIRs, htable, kernels, device='cpu'))
    old = weakref.ref(model._staged.value.signal[CPU])
    alive = []
    run = model._run_tiled_fit

    def watching(evaluation, chunk_fn_for, *args):
        def watched_for(device):
            fit_chunk = chunk_fn_for(device)

            def chunk(*a):
                alive.append(old() is not None)
                return fit_chunk(*a)
            return chunk
        return run(evaluation, watched_for, *args)
    model._run_tiled_fit = watching
    if case == 'new DIRs':
        model.fit(Ctx(y, other, htable, kernels, device='cpu'))
    else:
        model.fit(Ctx(y, DIRs, htable, kernels, device='cpu',
                      max_device_bytes=1))
    assert alive and not any(alive), alive
