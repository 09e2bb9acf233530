"""The configuration `vlp16_outdoor_egoreg`, the readers of the ego-motion
registration layer and, on a card, the reference's copy against the
program. Run from the repository root:

    python -m pytest slambench/tests -q -o addopts="" -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import ego_check, run, spec, traceread  # noqa: E402

EGO = "vlp16_outdoor_egoreg.robot-live"
MS = 1_000_000


def test_config_is_the_outdoor_preset_with_registration():
    """The file binds as `cli run --config` binds the upstream outdoor
    preset with `ego_motion: 3`: the preset's own registration block, 4
    rounds of up to 15 LM steps, saturation 5 m down to 1 m; every other
    value as `vlp16_outdoor`."""
    from lidarslam_tpu_torch.config import EgoMotionMode
    from lidarslam_tpu_torch.io import yaml_config

    f = spec.config("vlp16_outdoor_egoreg")
    cfg = run.slam_config(f)
    with open(ROOT / "configs" / "slam_config_outdoor.yaml") as fh:
        tree = yaml.safe_load(fh)
    tree["tpu"] = f["tpu"]
    tree["slam"]["ego_motion"] = 3
    assert yaml_config.config_from_tree(tree) == cfg
    assert cfg.ego_motion_mode == EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION
    assert (cfg.ego_motion_icp_max_iter, cfg.ego_motion_lm_max_iter) == (4, 15)
    m = cfg.ego_matching
    assert (m.init_saturation_distance, m.final_saturation_distance) == (5.0, 1.0)
    assert m.single_edge_per_ring and (m.edge_nb_neighbors, m.edge_min_nb_neighbors) == (8, 3)
    assert (m.plane_nb_neighbors, m.planarity_threshold, m.max_neighbors_distance) == (5, 0.04,
                                                                                       5.0)
    assert cfg == run.slam_config(spec.config("vlp16_outdoor")).replace(
        ego_motion_mode=EgoMotionMode.MOTION_EXTRAPOLATION_AND_REGISTRATION)
    base = spec.config("vlp16_outdoor")
    assert f["sensor"] == base["sensor"] and f["tpu"] == base["tpu"] and f["reduced"] == []
    prm = ego_check.params(f)
    assert (prm.icp_max_iter, prm.lm_max_iter, prm.edge_nb_neighbors) == (4, 15, 8)


def _trace(device=(), host=(), sweeps=2):
    return traceread.Trace(device=[(n, s * MS, e * MS) for n, s, e in device],
                           host=[(n, s * MS, e * MS) for n, s, e in host], sweeps=sweeps,
                           path="live", untraced_ms_per_sweep=50.0)


# two sweeps: the stage between its markers, kernels before and after it,
# and the counts as spans under each root
DEVICE = [("k0", 0, 2), ("slam_mark_ego_begin", 3, 4), ("knn_scan", 4, 6), ("k1", 5, 7),
          ("slam_mark_ego_end", 8, 9), ("k2", 8, 12),
          ("k0", 20, 21), ("slam_mark_ego_begin", 22, 23), ("k1", 24, 26),
          ("slam_mark_ego_end", 27, 28)]
HOST = [("slam.add_frame", 0, 15), ("slam.ego.counts", 14, 15), ("slam.ego.round", 14, 14),
        ("slam.ego.round", 14, 14), ("slam.ego.lm_step", 14, 14), ("slam.ego.lm_step", 14, 14),
        ("slam.ego.lm_step", 15, 15),
        ("slam.add_frame", 20, 30), ("slam.ego.counts", 29, 30), ("slam.ego.round", 29, 29),
        ("slam.ego.lm_step", 29, 29)]


@pytest.mark.parametrize("name,value", [
    # from 3 to 9: begin, knn_scan, k1 (3-7), end and k2 clipped to 9 (8-9);
    # from 22 to 28: begin, k1, end (1 + 2 + 1); k0 and k2's tail outside
    ("ego_device_ms_per_sweep.live", (5 + 4) / 2),
    ("ego_rounds_per_sweep.live", 3 / 2),
    ("ego_lm_steps_per_sweep.live", 4 / 2),
])
def test_ego_readers_on_a_hand_built_trace(name, value):
    read = spec.reader(name)
    assert read(_trace(DEVICE, HOST)) == pytest.approx(value)
    # a program without the markers or the counters, and a log run, read nothing
    assert read(_trace([d for d in DEVICE if "slam_mark" not in d[0]],
                       [h for h in HOST if not h[0].startswith("slam.ego")])) is None
    log = _trace(DEVICE, HOST)
    log.path = "log"
    assert read(log) is None


def test_ego_device_reader_pairs_each_begin_with_the_next_end():
    from importlib.util import module_from_spec, spec_from_file_location

    path = ROOT / "slambench" / "metrics" / "ego_device_ms_per_sweep.py"
    s = spec_from_file_location("ego_device_reader", path)
    mod = module_from_spec(s)
    s.loader.exec_module(mod)
    t = _trace(DEVICE)
    assert mod.stretches(t.device) == [(3 * MS, 9 * MS), (22 * MS, 28 * MS)]
    # an end with no begin before it, and a begin left open, pair with nothing
    lone = [("slam_mark_ego_end", 1, 2), ("slam_mark_ego_begin", 40, 41)]
    assert mod.stretches(_trace(DEVICE + lone).device) == mod.stretches(t.device)


def test_ego_metrics_are_listed_for_the_new_cell():
    bench = spec.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in ("ego_device_ms_per_sweep.live", "ego_rounds_per_sweep.live",
                 "ego_lm_steps_per_sweep.live"):
        m = listed[name]
        assert m["workloads"] == [EGO] and m["layer"] == "ego-motion registration"
        assert (m["source"], m["moves"]) == ("device_trace", "live_p50_ms")
    for cell in (EGO, "vlp16_outdoor.car-live"):
        assert spec.limits(cell)["missing"] == 0
        assert spec.traffic(spec.workload(bench, cell)["traffic"])["path"] == "live"


@pytest.mark.cuda
def test_reference_copy_holds_the_program_on_the_card(cuda_device):
    """One short window of the cell on the card: every sweep replays the
    live graph and the refined ego-motion of every 10th sweep holds to the
    reference's copy; the bfloat16 control does not."""
    sound = ego_check.check(EGO, 2**31 + 1501, 10.0)
    assert sound["within"] and sound["checked"] >= 3, sound
    assert sound["replays"] >= sound["sweeps"]
    assert all(r == rr for r, rr in sound["rounds"]) and sound["ref_failed"] == 0
    control = ego_check.check(EGO, 2**31 + 1501, 10.0, control="bf16")
    assert not control["within"], control
