"""Mixture-of-experts examples of the port."""
