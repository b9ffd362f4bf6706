"""Utilities of the port: ``gradient_check`` (numerical gradient checking)."""
