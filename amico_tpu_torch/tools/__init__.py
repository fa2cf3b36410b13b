"""Command-line tools of the port (counterparts of the repository's
``tools/``); each runs as ``python -m amico_tpu_torch.tools.<name>``."""
