"""Numerics: padding, FFT wrappers, spectral MAC, the fused block-conv
kernel and the overlap-save engine."""
