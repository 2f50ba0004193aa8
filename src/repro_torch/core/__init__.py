"""Numeric formats, stabilisers, error bounds and the spectral layer."""
