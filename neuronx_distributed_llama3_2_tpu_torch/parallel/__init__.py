"""Single-device linear and embedding layers with the JAX package's
parameter layouts; tensor parallelism comes with the multi-GPU slice."""
