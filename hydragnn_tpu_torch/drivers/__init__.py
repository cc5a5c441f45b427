"""Example drivers the port owns, each run as ``python -m
hydragnn_tpu_torch.drivers.<name>``: counterparts of the JAX package's
``examples/`` scripts with the reference's flags plus ``--device`` (the
card unless it names another), each ``main(argv)`` returning its report
as numbers (``common.py`` has what they share)."""
