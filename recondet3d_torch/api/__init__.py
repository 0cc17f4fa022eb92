"""Public API pieces of the port."""
