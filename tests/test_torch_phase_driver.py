"""PyTorch port, ``scripts/torch_multihost_phase.py``: the driver that runs
the host, multihost and bench_configs phases of ``chip_smoke.py`` alone.
On a machine without a card it must refuse every phase with a non-zero
exit, and it must refuse a phase it does not know."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _driver():
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_phase", REPO / "scripts" / "torch_multihost_phase.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("phase", ["host", "multihost", "bench_configs"])
def test_each_phase_needs_a_card(phase, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drv = _driver()
    assert phase in drv.PHASES
    assert drv.main(["--phases", phase, str(REPO)]) == 1
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


def test_unknown_phase_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        _driver().main(["--phases", "host,train", str(REPO)])
    assert exc.value.code == 2
    assert "phases are" in capsys.readouterr().err
