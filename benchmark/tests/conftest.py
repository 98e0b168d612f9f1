"""The small configuration each CPU test is parametrised over."""

import pytest

from benchmark.tests.small import SMALL


@pytest.fixture(params=sorted(SMALL))
def small_config(request):
    return request.param
