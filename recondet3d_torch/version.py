"""The package version (the port's copy of ``recondet3d/version.py``)."""

__version__ = "0.1.0"
