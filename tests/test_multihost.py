"""Multi-HOST dryrun as a test: 2 jax.distributed processes x 2 virtual
CPU devices each, running the sharded row-layout query step over a
process-spanning ("data", "table") mesh — the data axis crosses the
process boundary (the network), the table axis stays within a process
(NVLink on a GPU host).
Each worker verifies its row range against a single-device run
(metacache_tpu/parallel/multihost_dryrun.py prints MULTIHOST_OK).
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.mark.skipif(os.environ.get("MC_SKIP_MULTIHOST") == "1",
                    reason="multihost dryrun disabled")
def test_two_process_cluster():
    import __graft_entry__ as ge
    ge._dryrun_multiprocess(2, 2)
