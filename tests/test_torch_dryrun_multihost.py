"""``tools.dryrun.dryrun_multihost``: gloo CPU processes of a few shards
each run the sharded FM chain (left halos) and the sharded quadrature
demod (right halos) on one mesh, the halos crossing the process
boundaries through ``torch.distributed``, against the offline ops.  Two
processes test the boundary ranks; three give a middle rank that both
sends and receives.  Each case starts fresh interpreters that import
torch and join a process group (~6-8 s), so the test is ``slow``."""

import socket

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.parametrize("n_processes,per", [(2, 4), (3, 2)])
def test_torch_dryrun_multihost_gloo_processes(n_processes, per, capsys):
    from rustradio_tpu_torch.tools.dryrun import dryrun_multihost

    res = dryrun_multihost(n_processes, per, port=_free_port())
    assert res == {"ok": True, "processes": n_processes,
                   "devices": n_processes * per, "halo_bytes": 384}, res
    assert "dryrun_multihost: OK" in capsys.readouterr().out
