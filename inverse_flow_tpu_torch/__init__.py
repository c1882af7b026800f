"""inverse_flow_tpu_torch: the PyTorch and CUDA port of inverse_flow_tpu.

The JAX package ``inverse_flow_tpu`` is the reference this port is tested
against. The port imports ``torch`` and never ``jax``, and nothing of the
JAX package either: its data loaders and config have their own ports here.
"""

__version__ = "0.1.0"
