"""Serving: the inference engine."""
