"""Single-card flagship step."""
