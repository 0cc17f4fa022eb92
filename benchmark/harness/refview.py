"""DA3's reference view, which the check takes from the run it judges.

The any-view trunk picks one view a scene as its reference (the
configuration's ``saddle_balanced``: the least of a score over the views'
class tokens) and gives that view the reference camera token, so the camera
decoder's field of view of each view depends on the pick. On the
benchmark's noise images two views often score within rounding of each
other, and the program and the reference then pick different views without
either being wrong. As the point path follows the program's intrinsics, the
reference follows the run's pick: ``Recorder`` keeps the pick of the last
forward of the run's model (the program's, or the control's), and
``forced`` makes the reference take a given pick, recording how far the
pick lies from the reference's own least score (0 where both pick alike).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

__all__ = ["Recorder", "forced"]


class Recorder:
    """Wraps ``module.select_reference_view``; ``last`` holds the latest pick."""

    def __init__(self, module):
        self.module, self.inner = module, module.select_reference_view
        self.last: Optional[torch.Tensor] = None

        def pick(x, strategy="saddle_balanced"):
            self.last = self.inner(x, strategy=strategy)
            return self.last

        module.select_reference_view = pick

    def take(self) -> Optional[torch.Tensor]:
        return None if self.last is None else self.last.clone()

    def remove(self) -> None:
        self.module.select_reference_view = self.inner


@contextlib.contextmanager
def forced(idx: Optional[torch.Tensor], score_gaps: List[float]):
    """The reference's trunk takes the pick ``idx`` (B,); each forward
    appends to ``score_gaps`` the largest, over the scenes, of the
    reference's score of that pick less its least score."""
    from benchmark.reference import vit

    inner = vit.select_reference_view

    def pick(x, strategy="saddle_balanced"):
        own = inner(x, strategy=strategy)
        if idx is None:
            return own
        want = idx.to(own.device)
        if strategy == "saddle_balanced":  # the configurations' strategy
            score = vit.saddle_balanced_scores(x)
            score_gaps.append(float((score.gather(1, want[:, None])[:, 0] - score.amin(1)).max()))
        return want

    vit.select_reference_view = pick
    try:
        yield
    finally:
        vit.select_reference_view = inner
