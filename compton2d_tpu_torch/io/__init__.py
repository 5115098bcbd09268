"""I/O: event records, run outputs, the walltime guard and the Doppler
post-processing (copies of the JAX package's numpy-only modules)."""
