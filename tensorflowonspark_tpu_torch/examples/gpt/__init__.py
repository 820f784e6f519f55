"""GPT examples of the port."""
