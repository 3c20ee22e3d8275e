"""The port's last root tools on the CPU: ``generate_scenarios`` against
muvo_tpu's tools/generate_scenarios.py (byte-equal files), and the
end-to-end pipeline demo."""

import math
import sys
from pathlib import Path

import pytest

from muvo_tpu_torch.tools import e2e_pipeline_demo, generate_scenarios

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import tools.generate_scenarios as jax_generate_scenarios  # noqa: E402


@pytest.mark.parametrize("town", ["Town01", "Town03"])
def test_synthetic_scenarios_are_muvo_tpus_byte_for_byte(town, tmp_path,
                                                         monkeypatch):
    argv = ["--town", town, "--synthetic", "--n-routes", "4", "--seed", "7"]
    generate_scenarios.main(argv + ["--out", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["generate_scenarios.py", *argv,
                                      "--out", str(tmp_path / "jax")])
    jax_generate_scenarios.main()
    for name in ("routes.xml", "actors.json"):
        got = (tmp_path / "port" / "LeaderBoard" / town / name).read_bytes()
        want = (tmp_path / "jax" / "LeaderBoard" / town / name).read_bytes()
        assert got == want, name
    assert b"ego_vehicles" in got
    routes = (tmp_path / "port" / "LeaderBoard" / town / "routes.xml")
    assert routes.read_text().count("<route ") == 4


def test_e2e_pipeline_demo_runs_on_the_cpu(tmp_path, capsys):
    recon, imagine, losses = e2e_pipeline_demo.main(
        [str(tmp_path / "e2e"), "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("E2E PIPELINE OK")
    assert "collected episode 0" in out
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert {"psnr", "chamfer_distance", "voxel_iou"} <= set(recon)
    assert set(imagine) == set(recon)
    assert all(map(math.isfinite, [*recon.values(), *imagine.values()]))
