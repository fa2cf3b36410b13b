"""The inputs: the same seed gives the same subject, another seed another
one with the same shapes; the protocol and the files are as stated."""
import numpy as np
import torch

from portbench import nifti, registry, synth
from reference import dictionary


def _small():
    c = registry.config('freewater_human')
    c['protocol']['matrix'] = [10, 9, 6]
    c['mask']['semi_axes'] = [4.0, 3.5, 2.5]
    return c


def test_protocol_and_mask():
    for name, nS in (('noddi_ukb', 105), ('freewater_human', 55)):
        c = registry.config(name)
        b, g, t = synth.protocol(c)
        assert t is None
        assert b.shape == (nS,) and (b == 0).sum() == 5
        assert np.allclose(np.linalg.norm(g[b > 0], axis=1), 1, atol=1e-5)
        assert (b[:1 + (nS - 5) // 5] == 0).sum() == 1     # blocks interleave
    assert synth.mask(registry.config('noddi_ukb')).sum() == 186872


def test_subject_is_a_function_of_the_seed():
    c = _small()
    b, g, _ = synth.protocol(c)
    D = dictionary.build(c, b, g)
    an = torch.as_tensor(D['aniso'], dtype=torch.float32)
    iso = torch.as_tensor(D['iso'], dtype=torch.float32)
    big = 2 ** 31 + 12345
    v1, y1 = synth.subject(c, an, iso, big)
    v2, y2 = synth.subject(c, an, iso, big)
    v3, y3 = synth.subject(c, an, iso, big + 1)
    assert torch.equal(v1, v2) and torch.equal(y1, y2)
    assert v3.shape == v1.shape and not torch.equal(y1, y3)
    m = synth.mask(c)
    assert y1.shape == (int(m.sum()), b.size)
    # the file order (nS, Z, Y, X) holds each masked voxel's signal
    vol = v1.numpy().transpose(3, 2, 1, 0)
    assert np.array_equal(vol[m], y1.numpy())
    assert (y1 >= 0).all()


def test_nifti_round_trip_through_the_program(tmp_path):
    from amico_tpu_torch.io import nifti as port_nifti
    a = np.arange(4 * 3 * 2 * 5, dtype=np.float32).reshape(5, 2, 3, 4)
    path = str(tmp_path / 'x.nii')
    nifti.write(path, a, (4, 3, 2, 5), 2.0)
    back = nifti.read(path)
    assert back.shape == (4, 3, 2, 5)
    assert np.array_equal(back, a.transpose(3, 2, 1, 0))
    img = port_nifti.load(path)
    assert np.array_equal(np.asarray(img.dataobj), back)
    assert tuple(img.header.get_zooms()[:3]) == (2.0, 2.0, 2.0)
