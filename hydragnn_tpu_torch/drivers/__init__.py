"""Example drivers the port owns, each run as ``python -m
hydragnn_tpu_torch.drivers.<name>``: counterparts of the JAX package's
``examples/`` scripts that ``run_training`` does not reach."""
