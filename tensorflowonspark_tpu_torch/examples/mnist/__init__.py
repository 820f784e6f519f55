"""MNIST examples of the port."""
