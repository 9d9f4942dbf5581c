"""Support code of the port (timing on the card)."""
