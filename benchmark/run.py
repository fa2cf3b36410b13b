"""Entry point of the benchmark of amico_tpu_torch (see README.md):

    python3 benchmark/run.py --workload noddi.refit --seed 1 --seconds 30 --trace 0
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from portbench.main import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main())
