"""Bytes per element of a dtype name, the sizing convention of the traffic
engine's ``LayerStack`` lowering (``core/traffic.py``).

Only ``dtype_bytes`` and its tables are here so far; the roofline and
compile analysis around them come with a later slice of the port.
"""
from __future__ import annotations

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

# dtype-name spellings of the HLO shorthands above
_DTYPE_ALIASES = {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
                  "float64": "f64", "int8": "s8", "int32": "s32",
                  "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2"}


def dtype_bytes(dtype: str) -> int:
    """Bytes per element of an HLO-shorthand or long dtype name."""
    key = _DTYPE_ALIASES.get(dtype, dtype)
    if key not in _DTYPE_BYTES:
        raise KeyError(f"unknown dtype {dtype!r}")
    return _DTYPE_BYTES[key]
