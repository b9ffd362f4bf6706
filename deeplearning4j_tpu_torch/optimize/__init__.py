"""Updaters and gradient normalization of the port."""
