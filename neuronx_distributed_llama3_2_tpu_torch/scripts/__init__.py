"""Launchable scripts of the port (``python -m
neuronx_distributed_llama3_2_tpu_torch.scripts.<name>``)."""
