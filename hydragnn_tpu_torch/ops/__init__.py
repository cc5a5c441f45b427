"""Tensor ops and kernels of the port (counterpart of ``hydragnn_tpu/ops``)."""
