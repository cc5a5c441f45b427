"""Model zoo of the port (counterpart of ``hydragnn_tpu/models``)."""
