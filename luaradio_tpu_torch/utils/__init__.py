"""Filter design, windows and wire formats (host-side numpy)."""
