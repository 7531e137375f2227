"""The port's demos: counterparts of the JAX package's ``examples/``."""
