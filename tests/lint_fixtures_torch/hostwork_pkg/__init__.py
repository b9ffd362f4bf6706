"""DLT017 fixture package: a step root with host work two call hops deep."""

from .entry import predict  # noqa: F401
