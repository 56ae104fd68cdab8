"""Measurement scripts for the port, run on the card with ``python3 -m``."""
