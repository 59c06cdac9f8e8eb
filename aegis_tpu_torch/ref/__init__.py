"""NumPy pieces of the JAX package's CPU oracle (``aegis_tpu/ref``) that the
port's host code and constant tables are built from."""
