"""chip_smoke.py at a tiny size on the CPU: every phase's run and
oracle comparison, the four-card phases on the suite's virtual devices,
and the refusals (no GPU; no package beside the script)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    s = chip_smoke.Smoke(str(tmp_path_factory.mktemp("smoke")), n_frames=40)
    rec = s.load()
    assert rec["ok"] and rec["n_atoms"] == 3680 and rec["n_frames"] == 40
    return s


@pytest.mark.parametrize("phase", chip_smoke.ONE_CARD_PHASES,
                         ids=lambda p: p.__name__)
def test_one_card_phase(smoke, phase):
    rec = phase(smoke)
    json.dumps(rec)  # one JSON line per phase
    assert rec["ok"], rec
    assert rec["max_rel_err"] <= chip_smoke.REL_TOL
    assert rec["peak_bytes_in_use"] is None  # the CPU reports no stats


@pytest.mark.parametrize("phase,kw", [
    (chip_smoke.phase_atom_sharded, {"n_frames": 64, "n_atoms": 16}),
    (chip_smoke.phase_ring, {"n_frames": 64, "n_atoms": 4}),
    (chip_smoke.phase_sharded_fft, {"n_frames": 256, "n_atoms": 4}),
], ids=["atom_sharded", "ring", "sharded_fft"])
def test_multi_device_phase(phase, kw):
    import jax

    rec = phase(**kw)
    assert rec["ok"], rec
    assert rec["shard_devices"] == sorted(d.id for d in jax.devices())


def test_failed_phase_is_reported_not_raised(capsys):
    def boom():
        raise RuntimeError("phase broke")

    ok = chip_smoke.run_phases([("good", lambda: {"phase": "good",
                                                  "ok": True}),
                                ("bad", boom)])
    assert not ok
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["ok"] for r in lines] == [True, False]
    assert lines[1]["phase"] == "bad"


def test_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    captured = capsys.readouterr()
    assert "no GPU" in captured.err
    assert '"ok": true' not in captured.out


def test_refuses_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_rel_err_rejects_nonfinite_and_shape():
    import numpy as np

    assert chip_smoke.rel_err([1.0, np.nan], [1.0, 1.0]) == float("inf")
    with pytest.raises(ValueError):
        chip_smoke.rel_err(np.zeros(3), np.ones(4))
