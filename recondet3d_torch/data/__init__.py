"""Data processing of the port."""
