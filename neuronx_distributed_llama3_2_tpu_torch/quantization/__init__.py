"""Quantized storage: the paged KV pool's int8 / fp8 scale math."""
