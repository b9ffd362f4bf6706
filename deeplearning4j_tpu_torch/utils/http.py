"""Request-body admission for the stdlib HTTP servers of the port
(counterpart of ``deeplearning4j_tpu/utils/http.py``).

Content-Length is validated BEFORE any payload byte is read: a missing or
invalid length is a client error (400), an oversized or negative one is
413, and either way a hostile request costs one header parse, not server
memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["parse_content_length"]


def parse_content_length(headers, max_body_bytes: int
                         ) -> Tuple[Optional[int],
                                    Optional[Tuple[int, str]]]:
    """Validate a request's Content-Length against a body-size cap.

    Returns ``(length, None)`` when the request may be read, or
    ``(None, (status_code, message))`` for the structured error the
    caller should answer in its own JSON shape — without having read a
    single body byte."""
    try:
        length = int(headers.get("Content-Length", ""))
    except ValueError:
        return None, (400, "missing or invalid Content-Length")
    if length < 0 or length > max_body_bytes:
        return None, (413, f"request body {length}B exceeds the "
                           f"{max_body_bytes}B limit")
    return length, None
