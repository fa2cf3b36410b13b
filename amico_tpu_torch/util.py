"""Copy of ``amico_tpu/util.py`` for the port, which imports nothing of
``amico_tpu``: the reference's ``amico.util`` (verbosity controls, colored
logging and the scheme converters) at the import path its users expect.
"""
from .io.scheme import fsl2scheme, sandi2scheme
from .utils.logging import (AmicoError, ERROR, LOG, NOTE, PRINT, WARNING,
                            get_verbose, set_verbose)

__all__ = ['fsl2scheme', 'sandi2scheme', 'AmicoError', 'ERROR', 'LOG',
           'NOTE', 'PRINT', 'WARNING', 'get_verbose', 'set_verbose']
