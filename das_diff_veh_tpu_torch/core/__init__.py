"""Array containers of the port."""
