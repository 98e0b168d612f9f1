"""The ``cater`` and ``cater_kl`` chains run whole on the CPU and resume
(``test_torch_port_e2e.run_chain``), in a file of their own so that they run
beside the other chains' files.
"""

import pytest

from test_torch_port_e2e import one_torch_thread, run_chain  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("chain", ["cater", "cater_kl"])
def test_chain_runs_to_its_end_and_resumes(chain, tmp_path):
    run_chain(chain, tmp_path)
