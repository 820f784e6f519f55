"""Wide&Deep (Criteo) examples of the port."""
