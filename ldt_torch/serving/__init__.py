"""Serving paths of the port (`ldt_tpu/serving/`)."""
