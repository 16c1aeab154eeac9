"""Serving and demo helpers (for now, the zero-shot classifier loaders)."""
