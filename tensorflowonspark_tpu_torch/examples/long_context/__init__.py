"""Long-context examples of the port."""
