"""PyTorch/CUDA port of the framework, for NVIDIA Hopper (H100).

The JAX package ``neuronx_distributed_llama3_2_tpu`` beside it is the
reference this package is held against; the port imports nothing from it
and nothing of JAX. Module paths mirror the JAX package's, so a module's
counterpart is found at the same place. Entry points (model, weight
loader, engine) run on the card unless the caller passes ``device="cpu"``.
Kernels written by hand for ``sm_90a`` live under ``kernels/csrc`` and are
built by ``nvcc`` at first use (``kernels/_build.py``).
"""

__version__ = "0.1.0"
