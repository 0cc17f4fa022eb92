"""Command-line entry points of the port (so far: the config-driven model builder)."""
