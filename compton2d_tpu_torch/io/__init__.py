"""I/O: event records, run outputs, the walltime guard, the Doppler
post-processing, the legacy input importer and the disk-spectrum
generator (copies of the JAX package's numpy-only modules)."""
