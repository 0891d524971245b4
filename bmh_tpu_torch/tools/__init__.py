"""Measurement scripts for bmh_tpu_torch on the card."""
