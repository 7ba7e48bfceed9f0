"""chip_smoke.py on the CPU with its GPU check stubbed: the contract of its
last line, --multi selecting only its phase, the scale phase's oracle
check at a tiny size, and failure without a GPU or without the repo."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Gpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def stubbed(monkeypatch):
    """Phases replaced by recorders; the device phase reports a GPU."""
    calls = []
    monkeypatch.setattr(S, "phase_device",
                        lambda count: calls.append(("device", count))
                        or (_Gpu(), count))
    for name in ("golden", "scale", "multi"):
        monkeypatch.setattr(S, f"phase_{name}",
                            lambda *a, name=name: calls.append((name,)))
    return calls


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_last_line_contract(stubbed, capsys):
    assert S.main([]) == 0
    assert _last_line(capsys) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert stubbed == [("device", 1), ("golden",), ("scale",)]


def test_multi_runs_only_its_phase(stubbed, capsys):
    assert S.main(["--multi"]) == 0
    assert _last_line(capsys)["device"]["count"] == 4
    assert stubbed == [("device", 4), ("multi",)]


def test_require_gpu_refuses_the_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="not a GPU"):
        S.require_gpu(1)


def test_scale_phase_matches_oracle_tiny(capsys):
    """The scale phase end to end through the CLI on a tiny reference
    set: build, summary query, per-read query checked against the
    NumPy oracle."""
    S.phase_scale(seed=3, spec=[(3, 1, 0.0), (2, 3, 0.003)], glen=8000,
                  n_reads=3000, n_mapped=1024, n_oracle=256)
    out = capsys.readouterr().out
    assert "scale oracle: 256 per-read lines identical" in out


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
