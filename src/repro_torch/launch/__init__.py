"""Entry points of the port that a user runs as ``python -m``."""
