"""Set-transformer building blocks (counterpart of ldt_tpu/nn)."""
