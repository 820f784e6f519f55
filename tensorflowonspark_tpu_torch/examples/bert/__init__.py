"""BERT examples of the port."""
