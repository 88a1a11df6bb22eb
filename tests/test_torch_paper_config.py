"""``repro_torch.configs.paper`` holds the reference's paper constants,
name for name, so the port's benches take the same grids."""
import pytest

from repro.configs import paper as ref_paper
from repro_torch.configs import paper

NAMES = sorted(n for n in vars(ref_paper) if n.isupper())


def test_same_names():
    assert NAMES and sorted(n for n in vars(paper) if n.isupper()) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_same_value(name):
    ours, theirs = getattr(paper, name), getattr(ref_paper, name)
    assert type(ours) is type(theirs) and ours == theirs
