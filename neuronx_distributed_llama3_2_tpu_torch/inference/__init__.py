"""Inference: paged KV-cache decode model, sampling, the engine that
holds model and weights."""
