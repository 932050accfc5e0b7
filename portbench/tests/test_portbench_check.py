"""The check that decides ``correct``, driven through a whole run on the CPU
at a tiny size with the timed path broken underneath (the look for a card
skipped): each fault a cell can have comes out not correct; so does the
control, the reference in float8 in the program's place; the sound run is
correct. The limits are the serve cell's."""

import pytest
import torch

from portbench import harness
from tiny import make
from vitparticlefiltertracker_tpu_torch.filters import particle
from vitparticlefiltertracker_tpu_torch.filters.particle import PFState


def _wrap(tracker, change):
    """Replace the tracker's step by change(state, (new, out)) -> (new, out)."""
    step = tracker._fns.step

    def broken(prm, state, frame, **kw):
        return change(state, step(prm, state, frame, **kw))

    tracker._fns = tracker._fns._replace(step=broken)


def unchanged_state(tracker, mp):
    _wrap(tracker, lambda state, r: (state, r[1]))


def half_the_feeds_left_out(tracker, mp):
    def keep_half(state, r):
        new, out = r
        k = state.center.shape[0] // 2

        def mix(n, o):
            x = n.clone()
            x[k:] = o[k:]
            return x

        return type(state)(*(PFState(*map(mix, n, o)) if isinstance(n, PFState) else mix(n, o)
                             for n, o in zip(new, state))), out

    _wrap(tracker, keep_half)


def answer_altered(tracker, mp):
    _wrap(tracker, lambda state, r: (r[0], r[1]._replace(position=r[1].position + 3.0)))


def resample_skipped(tracker, mp):
    """The resampling step does nothing but reset the weights: every
    particle is its own ancestor."""
    mp.setattr(particle, "systematic_resample_indices",
               lambda w, u: torch.arange(w.shape[-1], device=w.device).expand(w.shape))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make(tmp_path_factory.mktemp("tiny"), feeds=2, cell="tiny-cell", lost_gate=False)


def test_sound_run_is_correct_and_the_control_is_not(bench):
    out = harness.run_cell("tiny-cell", 4242, 1.5, False, "cpu", bench_dir=bench, control=True)
    assert out["correct"], out["checks"]
    numbers = harness.cell_files("tiny-cell", bench)[0]["check"]["numbers"]
    over = [k for k, n in numbers.items() if out["control"]["values"][k] > n["limit"]]
    assert over, (out["control"]["values"], numbers)


@pytest.mark.parametrize("fault", [unchanged_state, half_the_feeds_left_out, answer_altered])
def test_each_fault_is_not_correct(bench, fault, monkeypatch):
    out = harness.run_cell("tiny-cell", 4243, 1.5, False, "cpu", bench_dir=bench,
                           plant=lambda tracker: fault(tracker, monkeypatch))
    assert not out["correct"], out["checks"]


def test_resample_skipped_shows_in_the_ancestor_share(bench, monkeypatch):
    """The transition comparison sees a resampling that draws no ancestor:
    nearly every particle lies elsewhere than the reference's. (No cell
    holds this share to a limit: on the card the float8 control does not
    read three times the program's; PERF.md gives the readings.)"""
    def ancestors_p50(out):
        return out["notes"]["gaps_p50_p90_max"]["ancestors"][0]

    sound = harness.run_cell("tiny-cell", 4244, 1.5, False, "cpu", bench_dir=bench)
    broken = harness.run_cell("tiny-cell", 4244, 1.5, False, "cpu", bench_dir=bench,
                              plant=lambda tracker: resample_skipped(tracker, monkeypatch))
    assert sound["notes"]["compared"]["transitions"] > 0 and broken["notes"]["compared"]["transitions"] > 0
    assert ancestors_p50(sound) <= 0.05
    assert ancestors_p50(broken) >= 0.9
