"""The facade's scatter of a fit's results into volumes (and FreeWater's
corrected DWI reinstated before it) against the semantics of the JAX
package's ``pipeline.scatter`` and ``pipeline.reinstate_corrected_dwi``,
written out here in NumPy (``scatter_oracle``, ``reinstate_oracle``) and
applied to the model's own rows: bit for bit, in every branch of
doNormalizeSignal x doKeepb0Intact x doMergeB0 and without b0.  A re-fit
leaves the previous fit's ``RESULTS`` as they were, and the counters
``scatter.host`` / ``scatter.card`` name the route the volumes took (host
on the CPU and on a checkpointed fit).  tests/test_torch_cuda.py holds the
card's route to the same oracle.

The helpers (``write_subject``, ``fit_subject``, ``RowSpy``,
``expected_volumes``, ``assert_bits_equal``) import no JAX, so the card's
tests use them too."""
import os

import numpy as np
import pytest
import torch

from amico_tpu_torch import trace

DIM = (6, 5, 4)
FW_LAMBDA2 = (1e-3, 4e-3)


def scatter_oracle(values, mask, dim):
    """``pipeline.scatter``: ``values`` (N, ...) at the mask's 1-voxels of
    a float32 volume, zero elsewhere."""
    values = np.asarray(values)
    vol = np.zeros(tuple(dim[:3]) + values.shape[1:], np.float32)
    vol[mask == 1] = values
    return vol


def reinstate_oracle(y_corrected, y, mean_b0_masked, b0_idx, normalized,
                     keep_b0):
    """``pipeline.reinstate_corrected_dwi``: the b0 normalisation undone
    and, if asked, the fitted signal's b0 samples put back."""
    out = y_corrected
    if normalized and mean_b0_masked is not None:
        out = out * mean_b0_masked.reshape(-1, 1)
        if keep_b0:
            out = out.copy()
            out[:, b0_idx] = y[:, b0_idx] * mean_b0_masked.reshape(-1, 1)
    elif keep_b0:
        out = out.copy()
        out[:, b0_idx] = y[:, b0_idx]
    return out


def assert_bits_equal(got, want, what):
    """Same dtype (float32), shape and bits."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and want.dtype == np.float32, what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), what


def write_subject(subj, nb0=3, seed=0):
    """A (6, 5, 4) subject: ``nb0`` b0 volumes of unequal level, 20
    directions at b = 1000 and at 2000 of a tensor-and-ball signal with
    noise, and a labeled mask (1: fitted; 2 and 0: not).  Returns the mask."""
    from amico_tpu_torch.io import nifti
    from amico_tpu_torch.testing import demo_scheme
    scheme = demo_scheme(nb0=nb0, shells=(1000.0, 2000.0), ndir=20)
    rng = np.random.RandomState(seed)
    n = int(np.prod(DIM))
    axes = rng.randn(n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    g, b = scheme.raw[:, :3], scheme.b
    cos2 = (axes @ g.T) ** 2
    tensor = np.exp(-b * (0.3e-3 + 1.4e-3 * cos2))
    f_iso = rng.uniform(0.0, 0.5, (n, 1))
    s0 = rng.uniform(600.0, 1000.0, (n, 1))
    sig = s0 * ((1 - f_iso) * tensor + f_iso * np.exp(-b * 3e-3))
    sig *= 1 + 0.02 * rng.randn(*sig.shape)
    sig[:, scheme.b0_idx] *= 1 + 0.1 * rng.rand(n, nb0) if nb0 else 1
    mask = (rng.rand(*DIM) < 0.7).astype(np.uint8)
    mask[rng.rand(*DIM) < 0.1] = 2
    os.makedirs(subj, exist_ok=True)
    nifti.save(nifti.Nifti1Image(
        np.abs(sig).astype(np.float32).reshape(DIM + (scheme.nS,)),
        np.diag([2.0, 2.0, 2.0, 1.0])), os.path.join(subj, 'DWI.nii'))
    nifti.save(nifti.Nifti1Image(mask), os.path.join(subj, 'mask.nii'))
    np.savetxt(os.path.join(subj, 'DWI.scheme'), scheme.raw[:, :4],
               fmt='%.6f', header='VERSION: BVECTOR', comments='')
    return mask


class RowSpy:
    """Wraps ``ev.model.fit``: keeps a host copy of the rows it returns
    (device rows copied to the host) and the device they were on."""

    def __init__(self, model, monkeypatch):
        self.rows, self.devices = {}, set()
        fit = model.fit

        def spy(evaluation):
            res = fit(evaluation)
            for k, v in res.items():
                if isinstance(v, torch.Tensor):
                    self.devices.add(v.device.type)
                    v = v.cpu().numpy()
                else:
                    self.devices.add('numpy')
                self.rows[k] = np.array(v, copy=True)
            return res
        monkeypatch.setattr(model, 'fit', spy)


def fit_subject(study, model, device='cpu', lambda2=None, **config):
    """``model`` ('NODDI' or 'FreeWater') through the port's facade on
    ``study``'s subject, every output asked for and ``config`` set before
    load_data; the LUT's atoms in ``study``/atoms (generated once).
    Returns the fitted Evaluation."""
    import amico_tpu_torch
    amico_tpu_torch.set_verbose(0)
    ev = amico_tpu_torch.Evaluation(study, 'subj', device=device)
    for k, v in dict(doComputeRMSE=True, doComputeNRMSE=True,
                     doSaveModulatedMaps=model == 'NODDI',
                     doSaveCorrectedDWI=model == 'FreeWater',
                     **config).items():
        ev.set_config(k, v)
    ev.load_data('DWI.nii', 'DWI.scheme', mask_filename='mask.nii')
    ev.set_model(model)
    if model == 'NODDI':
        ev.model.set(IC_VFs=np.linspace(0.3, 0.99, 4),
                     IC_ODs=np.array([0.06, 0.3, 0.8]))
    ev.set_config('ATOMS_path', os.path.join(study, 'atoms', model))
    ev.generate_kernels(ndirs=500)
    ev.load_kernels()
    if lambda2 is not None:
        ev.set_solver(lambda2=lambda2)
    return ev


def expected_volumes(ev, rows):
    """What the removed NumPy stages made of the model's ``rows``: every
    volume of ``ev.RESULTS``."""
    mask, dim = ev.niiMASK_img, ev.get_config('dim')
    want = {'MAPs': scatter_oracle(np.asarray(rows['estimates'], np.float32),
                                   mask, dim),
            'DIRs': scatter_oracle(np.asarray(ev.DIRs, np.float32), mask,
                                   dim),
            'RMSE': scatter_oracle(rows['rmse'], mask, dim),
            'NRMSE': scatter_oracle(rows['nrmse'], mask, dim)}
    if 'estimates_mod' in rows:
        want['MAPs_mod'] = scatter_oracle(
            np.asarray(rows['estimates_mod'], np.float32), mask, dim)
    if 'y_corrected' in rows:
        has_b0 = ev.scheme.b0_count > 0
        mean_b0 = (ev.mean_b0s[mask == 1] if ev.mean_b0s is not None
                   else None)
        b0_cols = (np.array([0]) if ev.get_config('doMergeB0')
                   else ev.scheme.b0_idx)
        yc = reinstate_oracle(
            rows['y_corrected'], ev.y, mean_b0, b0_cols,
            bool(ev.get_config('doNormalizeSignal')) and has_b0,
            bool(ev.get_config('doKeepb0Intact')) and has_b0)
        want['DWI_corrected'] = scatter_oracle(
            yc.astype(np.float32), mask, ev.niiDWI.shape[:3] + (yc.shape[1],))
    return want


def assert_results_are(ev, want):
    got = {k: v for k, v in ev.RESULTS.items() if k != 'RESULTS_path'}
    assert sorted(got) == sorted(want)
    outside = ev.niiMASK_img != 1
    for k, vol in got.items():
        assert_bits_equal(vol, want[k], k)
        assert not vol[outside].any(), k


def fit_counts(ev):
    """Fit ``ev`` traced; the ``fit`` span's counters."""
    trace.clear()
    trace.enable()
    try:
        ev.fit()
    finally:
        trace.disable()
    counts = trace.spans(name='fit')[-1]['counts']
    trace.clear()
    return counts


@pytest.fixture(scope='module')
def study(tmp_path_factory):
    root = tmp_path_factory.mktemp('scatter')
    os.environ['AMICO_TPU_HOME'] = str(root / 'home')
    torch.set_num_threads(1)
    write_subject(str(root / 'study' / 'subj'))
    return str(root / 'study')


@pytest.fixture(scope='module')
def study_no_b0(tmp_path_factory):
    root = tmp_path_factory.mktemp('scatter_no_b0')
    os.environ['AMICO_TPU_HOME'] = str(root / 'home')
    write_subject(str(root / 'study' / 'subj'), nb0=0)
    return str(root / 'study')


BRANCHES = [(n, k, m) for n in (True, False) for k in (True, False)
            for m in (False, True)]


@pytest.mark.parametrize('normalize,keep_b0,merge_b0', BRANCHES)
@pytest.mark.parametrize('model', ['FreeWater', 'NODDI'])
def test_results_equal_the_numpy_stages(study, monkeypatch, model,
                                        normalize, keep_b0, merge_b0):
    """Every volume of RESULTS is float32, of the volume's shape, zero
    outside the mask and, bit for bit, the removed NumPy scatter (and
    reinstatement) of the model's rows."""
    ev = fit_subject(study, model, doNormalizeSignal=normalize,
                     doKeepb0Intact=keep_b0, doMergeB0=merge_b0)
    spy = RowSpy(ev.model, monkeypatch)
    ev.fit()
    assert spy.devices == {'numpy'}
    want = expected_volumes(ev, spy.rows)
    assert ('DWI_corrected' in want) == (model == 'FreeWater')
    assert ev.RESULTS['MAPs'].shape == DIM + (len(ev.model.maps_name),)
    assert_results_are(ev, want)


def test_corrected_dwi_without_b0(study_no_b0, monkeypatch):
    """Without a b0 volume neither the normalisation nor the kept b0
    apply: the corrected DWI is the model's rows, scattered."""
    ev = fit_subject(study_no_b0, 'FreeWater', doNormalizeSignal=False,
                     doKeepb0Intact=True)
    spy = RowSpy(ev.model, monkeypatch)
    ev.fit()
    assert ev.scheme.b0_count == 0
    want = expected_volumes(ev, spy.rows)
    assert_bits_equal(want['DWI_corrected'], scatter_oracle(
        spy.rows['y_corrected'], ev.niiMASK_img,
        ev.niiDWI.shape[:3] + (ev.scheme.nS,)), 'oracle without b0')
    assert_results_are(ev, want)


@pytest.mark.parametrize('normalize,keep_b0,merge_b0', BRANCHES)
def test_oracles_are_the_jax_packages_stages(normalize, keep_b0, merge_b0):
    """The oracles here compute what ``amico_tpu.pipeline.scatter`` and
    ``reinstate_corrected_dwi`` do, bit for bit."""
    from amico_tpu import pipeline as pl
    rng = np.random.RandomState(int(normalize) + 2 * keep_b0 + 4 * merge_b0)
    mask = (rng.rand(*DIM) < 0.6).astype(np.uint8)
    mask[rng.rand(*DIM) < 0.1] = 2
    n = int((mask == 1).sum())
    y = rng.rand(n, 9).astype(np.float32)
    yc = rng.rand(n, 9).astype(np.float32)
    mean_b0 = (rng.rand(n) * 900 + 100).astype(np.float32)
    b0 = np.array([0]) if merge_b0 else np.array([0, 4])
    want = pl.reinstate_corrected_dwi(yc, y, mean_b0, b0, normalize, keep_b0)
    got = reinstate_oracle(yc, y, mean_b0, b0, normalize, keep_b0)
    assert_bits_equal(got, want, 'reinstate')
    for v in (yc[:, 0], yc, got):
        assert_bits_equal(scatter_oracle(v, mask, DIM),
                          pl.scatter(v, mask, DIM), 'scatter')


@pytest.mark.parametrize('model', ['FreeWater', 'NODDI'])
def test_refit_keeps_the_previous_results(study, tmp_path, model):
    """A re-fit at another lambda gives new arrays and leaves the previous
    fit's RESULTS as they were; on the CPU, and on a checkpointed fit, the
    volumes take the host route (every volume counted as scattered there,
    none on a card), and the checkpointed fit's volumes are the gathered
    fit's bit for bit."""
    ev = fit_subject(study, model, lambda2=FW_LAMBDA2[0])
    counts = fit_counts(ev)
    first = dict(ev.RESULTS)
    kept = {k: v.copy() for k, v in first.items()}
    n_vols = len(kept)
    assert counts['scatter.host'] == n_vols and 'scatter.card' not in counts
    ev.set_solver(lambda2=FW_LAMBDA2[1])
    ev.fit()
    for k, v in first.items():
        assert_bits_equal(v, kept[k], k)
        assert not np.shares_memory(v, ev.RESULTS[k]), k
    assert not np.array_equal(ev.RESULTS['MAPs'], kept['MAPs'])
    gathered = {k: v.copy() for k, v in ev.RESULTS.items()}
    ev.set_config('fit_checkpoint', str(tmp_path / 'fit.ckpt.npz'))
    ev.set_config('voxels_per_chunk', 32)
    counts = fit_counts(ev)
    assert counts['scatter.host'] == n_vols and 'scatter.card' not in counts
    assert ev.model._last_fit_timers['n_chunks'] > 1
    for k, v in gathered.items():
        assert_bits_equal(ev.RESULTS[k], v, k)
