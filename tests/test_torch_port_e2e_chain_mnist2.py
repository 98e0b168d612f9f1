"""The ``mnist2`` chain runs whole on the CPU and resumes
(``test_torch_port_e2e.run_chain``), in a file of its own so that it runs
beside the other chains' files.
"""

import pytest

from test_torch_port_e2e import one_torch_thread, run_chain  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("chain", ["mnist2"])
def test_chain_runs_to_its_end_and_resumes(chain, tmp_path):
    run_chain(chain, tmp_path)
