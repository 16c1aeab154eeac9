"""Synthetic training data made from a seed."""
