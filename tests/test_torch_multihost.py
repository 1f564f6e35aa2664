"""The port's multi-process dry run on the CPU (parallel/multihost.py): 2
"hosts" of 1 and of 2 gloo rank processes run the band-sharded binocular
step over one file:// rendezvous; every rank's loss is equal bit for bit
and within 1e-6 of a world-size-1 run (dryrun_multihost asserts both). And
the launcher stops every process when one of them fails."""

import sys
import time

import numpy as np
import pytest

from binocular3dgs_torch.parallel.multihost import dryrun_multihost, run_processes, run_worker


@pytest.mark.parametrize("hosts,local_ranks", [(2, 1), (2, 2)])
def test_dryrun_multihost(tmp_path, hosts, local_ranks):
    loss = dryrun_multihost(hosts, local_ranks, backend="gloo", device="cpu",
                            init_method=f"file://{tmp_path}/rendezvous", timeout=300)
    assert np.isfinite(loss) and loss > 0


def test_a_failed_process_stops_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited 3"):
        run_processes([[sys.executable, "-c", "import time; time.sleep(120)"],
                       [sys.executable, "-c", "import sys; sys.exit(3)"]], timeout=100)
    assert time.monotonic() - t0 < 60


def test_a_world_of_ranks_needs_a_rendezvous():
    with pytest.raises(ValueError, match="init_method"):
        run_worker(None, 2, 0, backend="gloo", device="cpu")
