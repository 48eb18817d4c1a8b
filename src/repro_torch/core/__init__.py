"""Core numerics of the port: block systems, dense block ops, spectral
analysis, and the APC building blocks (counterpart of ``repro.core``)."""
