"""Paged KV-cache serving: block pool, radix prefix cache, paged engine."""
