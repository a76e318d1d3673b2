"""Process-level helpers of the port (single process for now)."""
