"""Host-side utilities: IO, config, and conversion from the reference's arrays."""
