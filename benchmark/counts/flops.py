"""Operations of a request or a step, counted on the benchmark's plain
reference at the cell's shapes with ``torch.utils.flop_counter``: matrix
products and convolutions, forward and, for training, the backward of what
trains. The point path's selections are counted apart (``fps.py``)."""

from __future__ import annotations

__all__ = ["FlopCount"]


class FlopCount:
    """A context that adds the operations counted inside it to ``total``
    (re-entrant: each entry counts anew and adds)."""

    def __init__(self):
        self.total = 0.0
        self._mode = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._mode = FlopCounterMode(display=False)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self.total += float(self._mode.get_total_flops())
        self._mode = None
        return False
