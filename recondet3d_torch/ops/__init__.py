"""Ops of the port: attention and the kernel build."""
