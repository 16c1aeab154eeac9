"""The detector modules."""
