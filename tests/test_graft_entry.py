"""Entry-point contract: ``entry()`` compiles on one device, and
``dryrun_multichip(n)`` runs on the backend's own devices when it has n
of them, else says so and re-executes on n virtual CPU devices. Under
this suite the 8-device CPU backend already exists, so the inline path
runs; the subprocess re-exec path is smoke-tested once here too.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft


def test_entry_compiles_and_is_finite():
    import jax

    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    for o in jax.block_until_ready(out):
        assert np.all(np.isfinite(np.asarray(o)))


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_inline(n):
    graft.dryrun_multichip(n)


def test_dryrun_multichip_subprocess_reexec(monkeypatch, capfd):
    """Force the subprocess path even though this process has devices:
    simulates a backend with fewer devices than the mesh needs."""
    import jax

    monkeypatch.setattr(
        graft, "_dryrun_body",
        lambda n: (_ for _ in ()).throw(AssertionError("must re-exec")),
    )
    # pretend the current process can't satisfy the request
    monkeypatch.setattr(jax, "devices", lambda: [object()])
    graft.dryrun_multichip(2)
    assert "virtual CPU devices" in capfd.readouterr().out
