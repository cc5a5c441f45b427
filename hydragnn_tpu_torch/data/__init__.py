"""Host data plane of the port (counterpart of ``hydragnn_tpu/data``)."""
