"""Utilities of the port: ``gradient_check`` (numerical gradient checking),
``backoff`` (the retry-delay policy), ``serialization`` (the model and
checkpoint zip both packages read and write) and ``model_guesser``."""
