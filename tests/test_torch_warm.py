"""The warm re-fit state's records (``amico_tpu_torch.warm``): a value kept
under a key of objects compared by identity and values compared by ``==``,
and a value kept one a device."""
import gc
import weakref

import numpy as np
import pytest
import torch

from amico_tpu_torch.warm import Kept, PerDevice

CPU = torch.device('cpu')


class Value:
    """A built value a weakref can watch."""


def key(a, scheme, *vals):
    return (a, scheme), vals


# each case: the key of the second ask from the first one's (a, scheme,
# 'OLS', True), and whether it hits
CASES = {
    'the same objects': (lambda a, s: key(a, s, 'OLS', True), True),
    'an equal value made anew': (
        lambda a, s: key(a, s, ''.join(['O', 'L', 'S']), True), True),
    'an equal copy of an object': (lambda a, s: key(a.copy(), s, 'OLS',
                                                    True), False),
    'another object second': (lambda a, s: key(a, object(), 'OLS', True),
                              False),
    'a changed value': (lambda a, s: key(a, s, 'WLS', True), False),
    'a changed last value': (lambda a, s: key(a, s, 'OLS', False), False),
}


@pytest.mark.parametrize('case', list(CASES))
def test_kept_hits_on_the_same_objects_and_equal_values(case):
    """A second ask hits only when its objects are the key's (identity, so
    an equal copy misses) and its values equal the key's; a miss builds
    anew and keeps the new value under the new key."""
    a, scheme = np.arange(6.0), object()
    kept, built = Kept(), []

    def build():
        built.append(Value())
        return built[-1]
    first, hit = kept.get(*key(a, scheme, 'OLS', True), build)
    assert not hit and first is built[0] and kept.value is first
    second_key, want_hit = CASES[case]
    objs, vals = second_key(a, scheme)
    second, hit = kept.get(objs, vals, build)
    assert hit == want_hit
    assert (second is first) == want_hit and len(built) == 2 - want_hit
    again, hit = kept.get(objs, vals, build)
    assert hit and again is second and len(built) == 2 - want_hit


@pytest.mark.parametrize('how', ['drop', 'a miss'])
def test_kept_releases_the_old_value_before_building(how):
    """``drop()``, and a miss before ``build()`` runs, leave no reference
    to the old value or the key's objects: a miss never holds the old and
    the new value at once."""
    a = np.arange(4.0)
    kept = Kept()
    kept.get((a,), (1,), Value)
    old, old_a = weakref.ref(kept.value), weakref.ref(a)
    del a
    alive = []
    if how == 'drop':
        kept.drop()
        assert kept.value is None and kept.objs is None
    else:
        kept.get((np.arange(4.0),), (1,),
                 lambda: (gc.collect(), alive.append(old() is not None),
                          Value())[2])
        assert alive == [False]
    gc.collect()
    assert old() is None and old_a() is None


@pytest.mark.parametrize('n_devices', [1, 2])
def test_per_device_makes_each_once(n_devices):
    """One value a device, made on the first ask for that device and
    returned again after; ``clear()`` leaves no reference."""
    devices = [CPU, torch.device('meta')][:n_devices]
    store, made = PerDevice(), []

    def make_on(d):
        def make():
            made.append(d)
            return torch.zeros(3, device=d)
        return make
    first = [store.on(d, make_on(d)) for d in devices]
    again = [store.on(d, make_on(d)) for d in devices]
    assert made == devices
    assert all(x is y for x, y in zip(first, again))
    assert [t.device for t in first] == devices
    old = weakref.ref(first[0])
    del first, again
    store.clear()
    gc.collect()
    assert old() is None
