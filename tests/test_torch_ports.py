"""The port's one TCP port picker (``byteps_tpu_torch.utils.ports``): its
ports lie outside the kernel's ephemeral range, where a socket bound to
port 0 or an outgoing connection cannot take them, never repeat in a
process, and can be bound; and no module of the port, test helper of the
port or ``chip_smoke.py`` picks a port by binding to port 0 any more
(``launcher/launch.py`` excepted: a copy of the reference's launcher,
held to it by tests/test_torch_copies.py, that retries on fresh ports)."""

import glob
import os
import re
import socket

from byteps_tpu_torch.utils import ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKS = 200


def test_picks_lie_outside_the_ephemeral_range_and_never_repeat():
    low, high = ports.ephemeral_range()
    leaves_room = any(not low <= p <= high for p in range(10000, 65536))
    picked = [ports.free_port() for _ in range(PICKS)]
    assert len(set(picked)) == PICKS
    assert all(10000 <= p <= 65535 for p in picked)
    if leaves_room:
        assert not [p for p in picked if low <= p <= high]


def test_a_port_given_once_is_skipped(monkeypatch):
    first = ports.free_port()
    second = ports.free_port()
    offered = iter([first, first, second, first])
    real = ports.random.SystemRandom()

    class Pick:
        def choice(self, span):
            return next(offered, None) or real.choice(span)

    monkeypatch.setattr(ports.random, "SystemRandom", Pick)
    assert ports.free_port() not in (first, second)


def test_each_pick_can_be_bound():
    for _ in range(PICKS):
        port = ports.free_port()
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))
            assert s.getsockname()[1] == port


# bind((host, 0)): a literal port 0 after the host
_BIND_ZERO = re.compile(r"\.bind\(\(\s*[^,()]*,\s*0\s*\)\)")


def test_no_port_module_or_helper_binds_port_zero():
    assert _BIND_ZERO.search('s.bind(("127.0.0.1", 0))')
    assert _BIND_ZERO.search('s.bind(("localhost", 0))')
    files = (glob.glob(os.path.join(REPO, "byteps_tpu_torch", "**", "*.py"),
                       recursive=True)
             + glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))
             + glob.glob(os.path.join(REPO, "tests", "_torch_*.py"))
             + [os.path.join(REPO, "chip_smoke.py")])
    held = os.path.join(REPO, "byteps_tpu_torch", "launcher", "launch.py")
    this = os.path.abspath(__file__)
    binders = []
    for path in files:
        if path in (held, this):
            continue
        with open(path) as f:
            if _BIND_ZERO.search(f.read()):
                binders.append(os.path.relpath(path, REPO))
    assert binders == []
    with open(os.path.join(REPO, "byteps_tpu_torch", "dryrun.py")) as f:
        assert "free_port()" in f.read()
