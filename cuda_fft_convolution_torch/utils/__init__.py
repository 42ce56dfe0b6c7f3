"""Utilities: validation errors, FFT-size policies, configuration and
spectral checkpoints."""
