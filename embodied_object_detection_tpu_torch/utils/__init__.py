"""Host-side utilities: the TensorBoard scalar writer and the spans of
the port's work (`tracing.span`)."""
