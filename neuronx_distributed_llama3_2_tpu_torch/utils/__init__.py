"""Logging and device selection."""
