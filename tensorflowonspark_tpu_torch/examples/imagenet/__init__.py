"""ImageNet examples of the port."""
