"""The port's copies of the JAX package's jax-free modules compute what the
originals do: each case feeds the same numpy-seeded input to the original
(``amico_tpu``) and to its copy (``amico_tpu_torch``) and requires equal
results, bit for bit."""
import importlib
import os

import numpy as np
import pytest

PKGS = ('amico_tpu', 'amico_tpu_torch')


def mod(pkg, name):
    return importlib.import_module(f'{pkg}.{name}')


def same(a, b, path='result'):
    """Equal structure and equal values (NaN equal to NaN)."""
    if isinstance(a, dict) or hasattr(a, '__dict__') and not isinstance(
            a, (np.ndarray, type)):
        da = a if isinstance(a, dict) else vars(a)
        db = b if isinstance(b, dict) else vars(b)
        assert sorted(map(str, da)) == sorted(map(str, db)), path
        for k in da:
            same(da[k], db[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in 'fc'), path
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _bvector_table(rng):
    dirs = rng.randn(40, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    b = np.r_[np.zeros(4), np.full(18, 1000.0), np.full(18, 3000.0)]
    dirs[:4] = 0
    return np.c_[dirs, b]


def _stejskal_table(rng):
    dirs = rng.randn(30, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    G = np.r_[np.zeros(2), np.full(14, 0.06), np.full(14, 0.3)]
    dirs[:2] = 0
    n = dirs.shape[0]
    return np.c_[dirs, G, np.full(n, 0.035), np.full(n, 0.015),
                 np.full(n, 0.05)]


def case_scheme(pkg, tmp, rng):
    Scheme = mod(pkg, 'io.scheme').Scheme
    out = []
    for header, table in (('VERSION: BVECTOR', _bvector_table(rng)),
                          ('VERSION: 1', _stejskal_table(rng))):
        path = os.path.join(tmp, 'DWI.scheme')
        np.savetxt(path, table, fmt='%.10g', header=header, comments='')
        out += [vars(Scheme(path)), vars(Scheme(table, b0_thr=10))]
    bvals, bvecs = os.path.join(tmp, 'b.bval'), os.path.join(tmp, 'b.bvec')
    t = _bvector_table(rng)
    np.savetxt(bvals, t[:, 3][None])
    np.savetxt(bvecs, t[:, :3].T)
    fn = mod(pkg, 'io.scheme').fsl2scheme(bvals, bvecs,
                                          os.path.join(tmp, 'fsl.scheme'),
                                          flipAxes=(True, False, False))
    with open(fn) as f:
        out.append(f.read())
    return out


def case_nifti(pkg, tmp, rng):
    nifti = mod(pkg, 'io.nifti')
    vol = rng.rand(5, 4, 3, 7).astype(np.float32)
    affine = np.diag([2.0, 2.5, 3.0, 1.0])
    affine[:3, 3] = rng.randn(3)
    img = nifti.Nifti1Image(vol, affine)
    img.header.descrip = b'copy test'
    path = os.path.join(tmp, 'v.nii')
    nifti.save(img, path)
    back = nifti.load(path)
    with open(path, 'rb') as f:
        raw = f.read()
    nifti.save(nifti.Nifti1Image(vol[..., 0].astype(np.int16), affine),
               os.path.join(tmp, 'v16.nii.gz'))
    back16 = nifti.load(os.path.join(tmp, 'v16.nii.gz'))
    return [raw, np.asarray(back.get_fdata()), back.affine,
            vars(back.header), np.asarray(back16.dataobj), back16.affine]


def case_rotation(pkg, tmp, rng):
    lut = mod(pkg, 'lut')
    Scheme = mod(pkg, 'io.scheme').Scheme
    comp = mod(pkg, 'synthesis')
    scheme = Scheme(_bvector_table(rng))
    aux = lut.load_precomputed_rotation_matrices(12, 500)
    idx_in, idx_out = lut.aux_structures_generate(scheme, 12)
    ridx, Ylm = lut.aux_structures_resample(scheme, 12)
    high = lut.create_high_resolution_scheme(scheme, grad=aux.get('grad'))
    sig = comp.Zeppelin(high).get_signal(1.7e-3, 0.4e-3)
    iso = comp.Ball(high).get_signal(3e-3)
    lm = lut.rotate_kernel(sig, aux, idx_in, idx_out, False, 500)
    lm_iso = lut.rotate_kernel(iso, aux, idx_in, idx_out, True, 500)
    return [aux, [list(r) for r in idx_in], idx_out, ridx, Ylm, vars(high),
            lm, lm_iso,
            lut.resample_kernel(lm, scheme.nS, ridx, Ylm, False, 500),
            lut.resample_kernel(lm_iso, scheme.nS, ridx, Ylm, True, 500)]


def case_hash_tables(pkg, tmp, rng):
    lut = mod(pkg, 'lut')
    sphere = mod(pkg, 'ops.sphere')
    dirs = rng.randn(2000, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    out = []
    for n in (500, 1000):
        ht = lut.load_precomputed_hash_table(n)
        out += [ht, lut.load_directions(n), lut.dir_to_lut_idx(dirs, ht),
                sphere.build_hash_table(lut.load_directions(n))]
    return out + [lut.valid_dirs(), lut.highres_grad(),
                  sphere.resolve_source(500)]


def case_compartments(pkg, tmp, rng):
    Scheme = mod(pkg, 'io.scheme').Scheme
    c = mod(pkg, 'synthesis')
    st = Scheme(_stejskal_table(rng))
    bv = Scheme(_bvector_table(rng))
    return [c.Stick(st).get_signal(1.7e-3),
            c.Zeppelin(st).get_signal(1.7e-3, 0.5e-3),
            c.Ball(st).get_signal(3e-3),
            c.Tensor(st).get_signal(1.7e-3, 0.5e-3, 0.3e-3),
            c.CylinderGPD(st).get_signal(1.7e-3, 2e-6),
            c.CylinderGPD(st).get_signal(1.7e-3, 4e-6, 0.3, 1.1),
            c.SphereGPD(st).get_signal(2e-3, 5e-6),
            c.Astrosticks(st).get_signal(1.7e-3),
            c.NODDIIntraCellular(bv).get_signal(1.7e-3, 2.5),
            c.NODDIExtraCellular(bv).get_signal(1.7e-3, 2.5, 0.6),
            c.NODDIIsotropic(bv).get_signal(3e-3),
            c.watson_SH_coeff(4.0), c.scheme2noddi(bv)]


def case_sh_special_sphere(pkg, tmp, rng):
    sh = mod(pkg, 'ops.sh')
    special = mod(pkg, 'ops.special')
    sphere = mod(pkg, 'ops.sphere')
    x, y, z = rng.randn(3, 50)
    r, theta, phi = sh.cart2sphere(x, y, z)
    return [r, theta, phi, sh.num_sh_coeff(12), sh.sh_degree_info(8),
            sh.real_sh_basis(12, theta, phi), sh.sh_fit_matrix(8, theta, phi),
            special.cylinder_gpd_roots(), special.sphere_gpd_roots(),
            special.gpd_sum(special.cylinder_gpd_roots(), 0.035, 0.015,
                            1.7e-3, 3e-6, 1),
            sphere.fibonacci_hemisphere(77), sphere.grid_directions(),
            sphere.is_valid(500), sphere.is_valid(501)]


def case_native(pkg, tmp, rng):
    native = mod(pkg, 'ops.native')
    assert native.available()
    A = np.abs(rng.randn(40, 12))
    y = A @ (rng.rand(12) * (rng.rand(12) < 0.4)) + 0.01 * rng.randn(40)
    G = A.T @ A + 1e-3 * np.eye(12)
    raw = (rng.rand(6, 5, 4, 9) * 1000).astype(np.float32, order='F')
    raw[0, 0, 0, 3] = np.nan
    b0 = np.array([0, 4])
    pre = [native.preprocess_dwi(raw, b0, 1.0, 0.0, False, 0.0, 0.0, norm)
           for norm in (True, False)]
    mask = rng.rand(6, 5, 4) > 0.3
    vol = np.asfortranarray(raw[..., :7])
    vol[np.isnan(vol)] = 0
    gathered = [native.masked_gather_padded(vol, mask),
                native.masked_gather_padded(vol, mask, pad_rows=2,
                                            clip=False)]
    assert all(p is not None for p in pre + gathered)   # the native paths
    return [native.nnls(A, y), native.lasso(A, y, 0.5, 1e-3),
            native.lasso(A, y, 0.0, 4.0), native.qp_nonneg(G, A.T @ y),
            pre, gathered]


def case_pipeline(pkg, tmp, rng):
    pl = mod(pkg, 'pipeline')
    Scheme = mod(pkg, 'io.scheme').Scheme
    scheme = Scheme(_bvector_table(rng))
    img = (rng.rand(4, 3, 2, scheme.nS) * 100).astype(np.float32)
    mask = rng.rand(4, 3, 2) > 0.4
    normed, mean_b0 = pl.b0_normalize(img.copy(), scheme.b0_idx, 1e-3)
    y = pl.masked_voxels(normed, mask)
    sm_img, sm_scheme = pl.spherical_mean(img.copy(), scheme, 10)
    yc = rng.rand(*y.shape).astype(np.float32)
    return [pl.rescale_meaningful(2.0, 1.0), pl.rescale_meaningful(1.0, 0.0),
            pl.intensity_rescale(img.copy(), 2.0, 1.0), normed, mean_b0,
            pl.collapse_b0(img.copy(), scheme.b0_idx, scheme.dwi_idx), y,
            sm_img, vars(sm_scheme), pl.ensure_finite(img.copy(), 0.0, 'raw'),
            pl.scatter(y[:, 0], mask, mask.shape),
            pl.reinstate_corrected_dwi(yc, y, mean_b0[mask], scheme.b0_idx,
                                       True, True),
            pl.resolve_dti_method('LS'), pl.resolve_dti_method('RT')]


def case_alias_modules(pkg, tmp, rng):
    """util.py and scheme.py, the reference's amico.util / amico.scheme."""
    util, scheme = mod(pkg, 'util'), mod(pkg, 'scheme')
    bvals = os.path.join(tmp, 'b.bvals')
    bvecs = os.path.join(tmp, 'b.bvecs')
    tab = _bvector_table(rng)
    np.savetxt(bvals, tab[:, 3][None])
    np.savetxt(bvecs, tab[:, :3].T)
    out = os.path.join(tmp, 'out.scheme')
    util.fsl2scheme(bvals, bvecs, out)
    with open(out) as f:
        text = f.read()
    return [sorted(util.__all__), sorted(scheme.__all__), scheme.GAMMA,
            text, vars(scheme.Scheme(out))]


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith('case_')}


@pytest.mark.parametrize('case', sorted(CASES))
def test_copy_matches_original(case, tmp_path, monkeypatch):
    outs = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        # each package builds its own rotation-matrix cache
        monkeypatch.setenv('AMICO_TPU_HOME', str(d / 'home'))
        mod(pkg, 'utils.logging').set_verbose(0)
        outs.append(CASES[case](pkg, str(d), np.random.RandomState(7)))
    same(*outs)


def test_copies_name_their_originals_and_drop_jax_pieces():
    import amico_tpu_torch.lut as lut
    from amico_tpu_torch.utils.timers import StageTimers
    assert not hasattr(lut, 'dir_to_lut_idx_jax')
    t = StageTimers()
    with t.stage('x'):
        pass
    assert t.get('x') >= 0.0
    # the one difference of timers.py: profile=True opens a torch.profiler
    # range (jax.profiler.TraceAnnotation in the original), which a running
    # profiler records under the stage's name
    import torch.profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.stage('x', profile=True):
            torch.ones(2).add_(1)
    assert 'x' in {e.key for e in prof.key_averages()}
    assert t.get('x') >= 0.0
    import difflib
    import amico_tpu.utils.timers as original
    import amico_tpu_torch.utils.timers as copy

    def body(m):
        with open(m.__file__) as f:
            text = f.read()
        return text[text.index('class StageTimers'):].splitlines()
    changed = sorted(line[:2] + line[2:].strip()
                     for line in difflib.ndiff(body(original), body(copy))
                     if line[:2] in ('- ', '+ '))
    assert changed == sorted([
        '- try:', '- import jax.profiler',
        '- ctx = jax.profiler.TraceAnnotation(name)',
        '- except Exception:  # pragma: no cover - profiler unavailable',
        '- ctx = contextlib.nullcontext()',
        '+ import torch.profiler',
        '+ ctx = torch.profiler.record_function(name)']), changed
    root = os.path.dirname(lut.__file__)
    for rel in ('../io/nifti.py', '../io/scheme.py', 'refdata.py',
                'rotation.py', '../ops/sh.py', '../ops/special.py',
                '../ops/sphere.py', '../ops/native.py',
                '../synthesis/compartments.py', '../utils/logging.py',
                '../utils/progress.py', '../utils/timers.py', '../util.py',
                '../scheme.py'):
        with open(os.path.join(root, rel)) as f:
            head = f.read(200)
        want = 'amico_tpu/' + os.path.normpath(os.path.join('lut', rel))
        assert f'Copy of ``{want}``' in head, rel
