"""Datasets of the port (ccdm_tpu/data)."""
