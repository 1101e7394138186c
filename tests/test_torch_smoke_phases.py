"""chip_smoke.py's split of a profiled training step into its phases
(``device_us_by_phase``), on hand-made profiler events: each device
operation goes to the phase of the last phase marker before it on the
device's timeline, whatever the host's ranges say, and each marker names
its phase by its length."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

STEPS = 3
# The device operations of one step, by phase: (name, µs).
STEP = {"data": [("randn", 3.0)], "forward": [("traj_persistent<32, float>", 40.0)],
        "backward": [("bwd_chain", 50.0), ("bwd_weights", 20.0)],
        "optimizer": [("adam_prologue", 5.0), ("qadam_int8_sweep", 7.0)]}


class _Range:
    def __init__(self, start, us):
        self.start, self.end = start, start + us

    def elapsed_us(self):
        return self.end - self.start


def _event(name, start, us, device="CUDA", annotation=False):
    return SimpleNamespace(name=name, time_range=_Range(start, us), device_type=SimpleNamespace(name=device),
                           is_user_annotation=annotation)


def _mark_us(k, clock=1.0):
    """Phase marker k's device µs at ``clock`` times the H100's clock."""
    return chip_smoke.PHASE_MARK_US * chip_smoke.PHASE_MARK_STEP ** k / clock


def _session(host_offset_us=0.0, drop=(), between=(), clock=1.0):
    """A profile of STEPS phased steps: the session's marker, then per step
    phase k's marker before each phase k and marker 4 at its end, each
    phase's operations, ``between`` after each step's end marker; each
    phase's host range (``phase.<name>``) shifted by ``host_offset_us``
    against the device's timeline and mirrored onto it as an annotation.
    The device records at the indices in ``drop`` are left out, as the
    profiler does at times. Returns the profile, {phase: µs a step} of the
    operations it kept, and {(step, k): index} of the phase markers."""
    device, host, truth, marks, t = [], [], [], {}, 0.0

    def run(name, us, phase=None):
        nonlocal t
        device.append(_event(name, t, us))
        truth.append(phase)
        t += us + 1.0

    run(chip_smoke.MARKER, 1.5)
    for step in range(STEPS):
        for k, phase in enumerate(chip_smoke.PHASES):
            marks[step, k] = len(device)
            run(chip_smoke.MARKER, _mark_us(k, clock))
            start = t
            for name, us in STEP[phase]:
                run(name, us, phase)
            host.append(_event(f"phase.{phase}", start + host_offset_us, t - start, device="CPU"))
        marks[step, len(chip_smoke.PHASES)] = len(device)
        run(chip_smoke.MARKER, _mark_us(len(chip_smoke.PHASES), clock))
        for name, us in between:
            run(name, us, "data")
    kept = [i for i in range(len(device)) if i not in set(drop)]
    want = {phase: 0.0 for phase in chip_smoke.PHASES}
    for i in kept:
        if truth[i]:
            want[truth[i]] += device[i].time_range.elapsed_us() / STEPS
    annotations = [_event(e.name, e.time_range.start - host_offset_us, e.time_range.elapsed_us(), annotation=True)
                   for e in host]
    events = host + annotations + [device[i] for i in kept] + [_event("cudaLaunchKernel", 0.0, 2.0)]
    return SimpleNamespace(events=lambda: events), want, marks


@pytest.mark.parametrize("host_offset_us", [0.0, 150.0, -150.0, 1e4])
@pytest.mark.parametrize("clock", [0.7, 1.0, 1.4])
def test_phases_follow_the_device_markers(host_offset_us, clock):
    """Host ranges early, late or far off the device's timeline, the card's
    clock below or above the H100's: every phase holds its own operations
    once a step, and nothing else."""
    prof, want, _ = _session(host_offset_us, clock=clock)
    per, ops = chip_smoke.device_us_by_phase(None, prof, STEPS)
    assert per == pytest.approx(want)
    for phase, names in STEP.items():
        assert set(ops[phase]) == {name for name, _ in names}
        assert all(v["calls"] == pytest.approx(1.0) for v in ops[phase].values())


@pytest.mark.parametrize("leading", [1, 2, 3, 5, 7, 9])
def test_leading_records_left_out(leading):
    """The session's first records left out (its marker, then the first
    phases' markers and operations): what runs before the first marker
    recorded goes to the phase before it, and every later step is whole."""
    prof, want, _ = _session(drop=range(leading))
    per, ops = chip_smoke.device_us_by_phase(None, prof, STEPS)
    assert per == pytest.approx(want)
    assert all(v["calls"] == pytest.approx(1.0) for v in ops["optimizer"].values())


def test_a_marker_left_out_moves_its_phase_into_the_one_before():
    """Step 2's forward marker left out: its forward operations count as
    data; the optimizer phase still holds its own operations alone."""
    _, _, marks = _session()
    prof, _, _ = _session(drop=[marks[1, 1]])
    _, ops = chip_smoke.device_us_by_phase(None, prof, STEPS)
    assert ops["data"]["traj_persistent<32, float>"]["calls"] == pytest.approx(1 / STEPS)
    assert ops["forward"]["traj_persistent<32, float>"]["calls"] == pytest.approx(2 / STEPS)
    assert set(ops["optimizer"]) == {"adam_prologue", "qadam_int8_sweep"}


def test_what_runs_between_steps_counts_as_data():
    """Operations after a step's end marker go to "data", as those outside
    every phase did."""
    prof, want, _ = _session(between=[("fill", 2.0)])
    per, ops = chip_smoke.device_us_by_phase(None, prof, STEPS)
    assert per == pytest.approx(want)
    assert ops["data"]["fill"]["calls"] == pytest.approx(1.0) and "fill" not in ops["optimizer"]


@pytest.mark.parametrize("clock", [0.7, 1.0, 1.4])
def test_each_marker_names_its_phase(clock):
    """A marker's length names its call k (0-4) within a factor of the
    clock; the session's marker (a short spin) and other kernels name
    none."""
    for k in range(len(chip_smoke.PHASES) + 1):
        assert chip_smoke.phase_mark(_event(chip_smoke.MARKER, 0.0, _mark_us(k, clock))) == k
    assert chip_smoke.phase_mark(_event(chip_smoke.MARKER, 0.0, 1.5)) is None
    assert chip_smoke.phase_mark(_event("bwd_chain", 0.0, _mark_us(2))) is None
