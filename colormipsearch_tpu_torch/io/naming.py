"""MIP library naming rules (the part of cmd/MIPsHandlingUtils.java the
neuron JSON reader needs)."""

from __future__ import annotations


def is_em_library(library: str | None) -> bool:
    """MIPsHandlingUtils.isEmLibrary:116-120."""
    if not library:
        return False
    low = library.lower()
    return low.startswith("flyem") or low.startswith("flywire") \
        or "_em_" in low or "hemibrain" in low or "manc" in low
