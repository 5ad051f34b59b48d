"""Model zoo of the port (CTR models in this slice)."""
