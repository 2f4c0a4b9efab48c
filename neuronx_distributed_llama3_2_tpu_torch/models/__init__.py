"""Model definitions (Llama-3 / Llama-3.2, inference subset)."""
