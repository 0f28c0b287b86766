"""Command-line recipes of the port (counterparts of the JAX package's
``tools/`` scripts), each runnable with ``python -m``."""
