"""Saturation guards with the degradation ladder (``guard``) and
deterministic fault injection (``chaos``): copies of the JAX package's
modules of the same names."""
