"""Part of bmh_tpu_torch."""
