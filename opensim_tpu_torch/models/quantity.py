"""Kubernetes resource-quantity parsing.

The reference relies on ``k8s.io/apimachinery``'s ``resource.Quantity``
(used throughout e.g. ``pkg/simulator/plugin/simon.go:57-66``). This module
implements the subset of quantity semantics the simulator needs: parsing
decimal/binary-SI suffixed strings to numeric base units and formatting them
back for reports.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Union

# Binary SI (power-of-two) suffixes.
_BINARY: Dict[str, int] = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
# Decimal SI suffixes (note lowercase k, as in upstream).
_DECIMAL: Dict[str, Union[int, Fraction]] = {
    "n": Fraction(1, 10**9),
    "u": Fraction(1, 10**6),
    "m": Fraction(1, 1000),
    "": Fraction(1),
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}


def parse_quantity(value: object) -> float:
    """Parse a Kubernetes quantity (e.g. ``"1500m"``, ``"16Gi"``, ``2``) to a
    float in base units."""
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        return 0.0
    # Scientific notation like "1e3" is legal in k8s quantities.
    for suffix in _BINARY:
        if s.endswith(suffix):
            return float(Fraction(s[: -len(suffix)]) * _BINARY[suffix])
    # Longest decimal suffixes are single-char; check exponent form first.
    try:
        return float(s)
    except ValueError:
        pass
    suffix = s[-1]
    if suffix in _DECIMAL:
        num = s[:-1]
        return float(Fraction(num) * _DECIMAL[suffix])
    raise ValueError(f"unparseable quantity: {value!r}")


def parse_quantity_milli(value: object) -> int:
    """Parse to integer milli-units (the natural unit for CPU)."""
    return int(round(parse_quantity(value) * 1000))


def format_quantity(value: float, binary: bool = True) -> str:
    """Human-readable rendering for reports (mirrors how pterm tables in
    ``pkg/apply/apply.go:309-687`` show Gi/Mi quantities)."""
    if value == 0:
        return "0"
    if binary:
        for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
            unit = _BINARY[suffix]
            if abs(value) >= unit:
                v = value / unit
                if abs(v - round(v)) < 1e-9:
                    return f"{int(round(v))}{suffix}"
                return f"{v:.2f}{suffix}"
    if abs(value - round(value)) < 1e-9:
        return str(int(round(value)))
    return f"{value:.3f}"


def format_milli(value_milli: int) -> str:
    """Render a milli quantity (CPU) like kubectl does."""
    if value_milli % 1000 == 0:
        return str(value_milli // 1000)
    return f"{value_milli}m"
