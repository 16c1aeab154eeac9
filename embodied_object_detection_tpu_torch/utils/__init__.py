"""Host-side utilities: the TensorBoard scalar writer."""
