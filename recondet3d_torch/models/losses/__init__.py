"""Losses of the port."""
