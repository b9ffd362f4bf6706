"""Binary wire format for tensor payloads over the HTTP tiers
(counterpart of ``deeplearning4j_tpu/serving/wire.py``; the frames are
the JAX package's byte for byte, both ways).

Base64 of raw little-endian array bytes plus enough JSON to rebuild the
array::

    {"x_b64": "<base64>", "dtype": "float32", "shape": [4, 784]}

- ``float32`` — the native serving dtype.
- ``float64`` — accepted, downcast to float32 on decode.
- ``int8`` — only meaningful against a known symmetric grid, so decode
  needs a scale: the endpoint's calibrated input grid (quantized models),
  the index's table grid (int8 and int4 retrieval indexes), or an
  explicit ``"scale"`` field. ``x ≈ x_int8 * scale``.

Responses carry arrays the same way (``encode_array``): retrieval
endpoints answer ``indices_b64`` / ``distances_b64`` when the client asks
for ``"b64": true``.
"""

from __future__ import annotations

import base64
from typing import Optional

import numpy as np

__all__ = ["WIRE_DTYPES", "decode_array", "encode_array"]

WIRE_DTYPES = ("float32", "float64", "int8")


def decode_array(body: dict, *, field: str = "x_b64",
                 int8_scale: Optional[float] = None,
                 allow_explicit_scale: bool = True,
                 int8_hint: str = "int8 payloads need a quantized "
                                  "endpoint; send float32") -> np.ndarray:
    """Decode ``{field, "dtype", "shape"}`` from a JSON body into a float32
    array. ``int8_scale`` is the symmetric grid int8 payloads are decoded
    on; when None an explicit ``"scale"`` field is honoured (unless
    ``allow_explicit_scale=False``: quantized model endpoints own their
    grid) and its absence raises ``ValueError(int8_hint)``, which the HTTP
    layers map to a structured 400."""
    dtype = str(body.get("dtype", "float32"))
    if dtype not in WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype '{dtype}' "
                         f"(supported: {list(WIRE_DTYPES)})")
    shape = body.get("shape")
    if (not isinstance(shape, (list, tuple)) or not shape
            or not all(isinstance(d, int) and d > 0 for d in shape)):
        raise ValueError("binary payloads need 'shape': a non-empty list "
                         "of positive ints")
    raw = base64.b64decode(str(body[field]), validate=True)
    dt = np.dtype(dtype).newbyteorder("<")
    expected = int(np.prod(shape)) * dt.itemsize
    if len(raw) != expected:
        raise ValueError(
            f"payload is {len(raw)} bytes but shape {list(shape)} of "
            f"{dtype} needs {expected}")
    arr = np.frombuffer(raw, dtype=dt).reshape(shape)
    if dtype == "int8":
        scale = int8_scale
        if scale is None and allow_explicit_scale and "scale" in body:
            scale = float(body["scale"])
        if scale is None:
            raise ValueError(int8_hint)
        return arr.astype(np.float32) * np.float32(scale)
    return np.ascontiguousarray(arr, dtype=np.float32)


def encode_array(arr: np.ndarray, field: str = "x_b64") -> dict:
    """The response-side encoding: little-endian raw bytes, base64."""
    a = np.ascontiguousarray(arr)
    le = a.astype(a.dtype.newbyteorder("<"), copy=False)
    return {field: base64.b64encode(le.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}
