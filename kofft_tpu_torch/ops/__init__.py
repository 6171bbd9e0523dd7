"""Transforms of the port: the 1-D complex FFT slice."""
