"""The second half of the prefix-cached family matrix of
``tests/test_torch_prefix_families.py`` (its :data:`SECOND` archs: the
encoder-decoder and the hybrid, whose published prefix outruns its K/V
ring), in a file of its own so that a test run spread over workers by
file runs the halves side by side."""
import pytest

from tests.test_torch_prefix_families import SECOND, check_family


@pytest.mark.parametrize("arch", SECOND)
def test_family_prefix_chunked_paged_matches_monolithic(arch):
    check_family(arch)
