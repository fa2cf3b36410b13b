"""The plain reference that decides ``correct``: NumPy and SciPy only, and
nothing of the program."""
