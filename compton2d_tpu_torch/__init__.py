"""compton2d_tpu_torch — the PyTorch + CUDA port of compton2d_tpu.

Module names mirror the JAX package ``compton2d_tpu`` so each function
has an obvious counterpart there; the JAX package is the reference the
port's tests hold it against. The port never imports jax nor the JAX
package: the reference's jax-free modules it needs (``config``,
``constants``, ``units``, ``physics.icloss``, ``physics.reflection``)
are copied here under the same names.

The per-photon work of a step runs in one hand-written CUDA kernel,
``csrc/flight.cu`` (see ``transport.flight``); everything else is
batched PyTorch over zones or slots, in float32 with TF32 off
(``policy``).
"""
from compton2d_tpu_torch import policy  # noqa: F401

__all__ = ["policy"]
