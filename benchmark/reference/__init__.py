"""The plain reference of the benchmark's configurations: a frozen copy of the
port's plain PyTorch paths (no hand kernel; plain attention, plain FPS), with
the package's imports rewritten to this folder. It imports nothing of the
program."""
