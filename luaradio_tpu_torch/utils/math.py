"""Math helpers (reference: radio/utilities/math_utils.lua)."""

from __future__ import annotations


def ceil_log2(n: int) -> int:
    """Smallest k with 2**k >= n (reference math_utils.lua ceil_log2)."""
    if n <= 0:
        raise ValueError("n must be positive")
    return (n - 1).bit_length()


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def next_pow2(n: int) -> int:
    return 1 << ceil_log2(max(1, n))


__all__ = ["ceil_log2", "is_pow2", "next_pow2"]
