"""Segmentation examples of the port."""
