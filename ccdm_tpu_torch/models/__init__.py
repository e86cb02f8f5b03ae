"""Denoiser networks of the port."""
