"""``python -m amico_tpu_torch`` entry point (see amico_tpu_torch.cli)."""
import sys

from .cli import main

if __name__ == '__main__':
    sys.exit(main())
