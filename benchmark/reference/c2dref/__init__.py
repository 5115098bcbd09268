"""A frozen copy of the port's plain step (``compton2d_tpu_torch`` as of
the benchmark's first version), the benchmark's reference.

Each module is the port's module of the same name with its imports
pointed here; ``transport.flight`` keeps only the kernel's plain version
(``flight_step`` runs ``flight_step_reference`` on every device), and
``step`` holds the driver's phase order (``_step_impl``) and the set-up it
reads (:class:`step.Reference`). The copy imports nothing of the port, of
the JAX package or of JAX, and later changes to the port do not reach it.
"""
