"""Parameter conversion into the port."""
