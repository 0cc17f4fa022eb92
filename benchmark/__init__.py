"""The benchmark of recondet3d_torch: run one cell with ``python3 benchmark/run.py``."""
