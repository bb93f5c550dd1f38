"""A run with the timed path broken underneath comes out not correct: a
step that leaves the state unchanged, half of the batch left out (the
mean over the rest), an answer altered where it is produced. The run is
driven whole, on the CPU at the tiny size, with the look for a card
skipped."""

import json

import pytest

from benchmark import run
from benchmark.tests import tiny


def run_line(capsys, cell: str) -> dict:
    assert run.main(["--workload", cell, "--seed", "4000000007", "--seconds", "0.2",
                     "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tile2p24.train_b16", "tile2p24.train_b14"])
def test_unchanged_state(monkeypatch, capsys, cell):
    from scanerf_tpu_torch.train import tile

    tiny.patch(monkeypatch)
    monkeypatch.setattr(tile, "apply_gradients", lambda state, grads, tc: None)
    line = run_line(capsys, cell)
    assert not line["correct"]
    assert line["checks"]["change"]["value"] > line["checks"]["change"]["limit"]


@pytest.mark.parametrize("cell", ["tile2p24.train_b16", "tile2p24.train_b14"])
def test_half_the_batch(monkeypatch, capsys, cell):
    from scanerf_tpu_torch.train import tile

    tiny.patch(monkeypatch)
    step = tile.train_step

    def half(state, data, tc, generator=None, ray_idx=None, pixel_locs=None, **kw):
        keep = ray_idx.shape[0] // 8 * 4
        return step(state, data, tc, ray_idx=ray_idx[:keep], pixel_locs=pixel_locs[:, :keep],
                    **kw)

    monkeypatch.setattr(tile, "train_step", half)
    line = run_line(capsys, cell)
    assert not line["correct"]
    assert line["checks"]["loss"]["value"] > line["checks"]["loss"]["limit"]


@pytest.mark.parametrize("cell", ["city2x2p24.overhead_720p", "city2x2p24.horizon_720p"])
def test_answer_altered(monkeypatch, capsys, cell):
    from scanerf_tpu_torch.render import renderer

    tiny.patch(monkeypatch)
    render_rays = renderer.render_rays

    def altered(*a, **kw):  # every seventh ray of a chunk brighter
        out = render_rays(*a, **kw)
        out["rgb"] = out["rgb"].clone()
        out["rgb"][::7] = (out["rgb"][::7] + 0.02).clamp(0.0, 1.0)
        return out

    monkeypatch.setattr(renderer, "render_rays", altered)
    line = run_line(capsys, cell)
    assert not line["correct"]
    assert line["checks"]["rgb"]["value"] > line["checks"]["rgb"]["limit"]


def test_sound_runs_stay_correct(monkeypatch, capsys):
    """The same runs without a fault are correct (the faults above are what
    fail them)."""
    tiny.patch(monkeypatch)
    for cell in ("tile2p24.train_b14", "city2x2p24.horizon_720p"):
        assert run_line(capsys, cell)["correct"]
