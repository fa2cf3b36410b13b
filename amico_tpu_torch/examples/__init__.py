"""The JAX package's three examples, on the port.

Each is a module run with ``python -m``, on the card unless ``--device
cpu`` is given (without a card it raises :class:`AmicoError`):

    python -m amico_tpu_torch.examples.noddi_demo [study_dir] [--device cpu]
    python -m amico_tpu_torch.examples.fsl_noddi_tutorial [study_dir] [...]
    python -m amico_tpu_torch.examples.sweep_multichip_demo [study_dir] [...]

Each module's ``run(study, device, dim)`` is its body, which ``main()``
calls at the JAX example's sizes.
"""
