"""State and parameter exchange."""
