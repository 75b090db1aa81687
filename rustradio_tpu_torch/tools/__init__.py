"""Scripts that measure the port on the card."""
