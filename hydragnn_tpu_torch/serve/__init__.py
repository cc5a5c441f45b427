"""Online serving of the port (counterpart of ``hydragnn_tpu/serve``)."""
