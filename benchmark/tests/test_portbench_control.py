"""The control: the reference computed in TF32 put in the program's place
has to come out as not correct, at a size a test run holds (the cells'
own sizes: ``readings.py --control`` on the card, PERF.md)."""
import pytest

from conftest import small_bench
from portbench import judge, registry
from portbench.cells import Cell


@pytest.mark.parametrize('config,traffic', [
    ('noddi_ukb', 'refit_up'), ('noddi_ukb', 'study'),
    ('freewater_human', 'refit'), ('freewater_human', 'refit_dwi')])
def test_control_fails(tmp_path, config, traffic):
    d = str(tmp_path / 'bench')
    small_bench(d, noddi_grid=True)
    cell = Cell(registry.config(config + '_tiny', d),
                registry.traffic(traffic, d), 2 ** 31 + 99, 'cpu',
                str(tmp_path / 'work'))
    cell.inputs(write=False)
    numbers = cell.check('tf32')
    assert not judge.verdict(numbers), numbers
