"""Weight carry-over into the port (ALPRO state-dict key space)."""
