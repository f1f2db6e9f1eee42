"""chip_smoke.py: the GPU start-up proof, checked on the CPU.

The script itself refuses to run without a GPU; its phase functions and
parity plumbing run here at tiny sizes, with the CPU standing in for
both the device under test and the oracle.
"""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture
def report(capsys):
    return chip_smoke.Report("TestCard, 0.00 W")


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_refuses_without_gpu():
    """Under JAX_PLATFORMS=cpu the script exits non-zero before any
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_phase_wing_ab_tiny(report, capsys):
    """Phase A at num_el=2, p=2: both paths in turns, parity vs the
    oracle, medians per path."""
    cpu = jax.devices("cpu")[0]
    times = chip_smoke.phase_wing_ab(report, cpu, cpu, num_el=2, p=2)
    assert set(times) == {"direct", "mixed"}
    for t in times.values():
        assert len(t["warm"]) == 6 and len(t["big"]) == 2
    lines = _lines(capsys)
    assert all(ln.startswith("[TestCard, 0.00 W]") for ln in lines)
    assert any("dJdh_rel_vs_cpu" in ln for ln in lines)


def test_phase_tbeam_mi_tiny(report):
    cpu = jax.devices("cpu")[0]
    r = chip_smoke.phase_tbeam_mi(report, cpu, cpu, num_el=4, p=2,
                                  n_pts=5)
    assert r <= chip_smoke.GRAD_TOL


def test_parity_check_raises():
    with pytest.raises(AssertionError, match="parity"):
        chip_smoke.check(chip_smoke.rel([1.0, 2.0], [1.0, 2.1]) <= 1e-6,
                         "parity off")


def test_report_line_format(capsys):
    chip_smoke.Report("Card X, 700.00 W")("phase Z", a=1.5, b=[1, 2.0],
                                          c=None)
    line = _lines(capsys)[-1]
    assert line == "[Card X, 700.00 W] phase Z: a=1.5 b=[1,2] c=None"
    with pytest.raises(json.JSONDecodeError):
        json.loads(line)


@pytest.mark.gpu
def test_phase_tbeam_mi_on_gpu(report, gpu_device):
    """Phase C at tiny size on the card, against the CPU oracle."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(gpu_device):
        r = chip_smoke.phase_tbeam_mi(report, cpu, gpu_device, num_el=4,
                                      p=2, n_pts=5)
    assert r <= chip_smoke.GRAD_TOL
