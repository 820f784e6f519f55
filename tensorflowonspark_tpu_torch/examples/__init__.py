"""The port's versions of the JAX package's ``examples/``, one module each
at the same relative path, runnable with ``python -m``."""
