"""DA3's reference view: the run's pick is recorded, and the reference takes
it, with the gap of its score to the reference's own least."""

import torch

from benchmark.harness.refview import Recorder, forced
from benchmark.reference import vit


def _tokens(seed=0, B=2, S=6):
    return torch.randn(B, S, 3, 16, generator=torch.Generator().manual_seed(seed))


def test_the_recorder_keeps_the_last_pick_and_lets_go():
    inner = vit.select_reference_view
    rec = Recorder(vit)
    try:
        x = _tokens()
        got = vit.select_reference_view(x)
        assert torch.equal(rec.take(), inner(x)) and torch.equal(got, inner(x))
    finally:
        rec.remove()
    assert vit.select_reference_view is inner


def test_the_reference_takes_the_forced_pick_and_reads_its_score_gap():
    x = _tokens(1)
    score = vit.saddle_balanced_scores(x)
    own = vit.select_reference_view(x)
    assert torch.equal(own, score.argmin(1))
    other = (own + 1) % x.shape[1]
    gaps = []
    with forced(other, gaps):
        assert torch.equal(vit.select_reference_view(x), other)
    want = float((score.gather(1, other[:, None])[:, 0] - score.amin(1)).max())
    assert gaps == [want] and want > 0
    gaps = []
    with forced(own, gaps):
        assert torch.equal(vit.select_reference_view(x), own)
    assert gaps == [0.0]
    with forced(None, gaps):  # nothing recorded: the reference picks its own
        assert torch.equal(vit.select_reference_view(x), own)
    assert vit.select_reference_view.__name__ == "select_reference_view"
