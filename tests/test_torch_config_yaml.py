"""The port's YAML configs (slide_slam_tpu_torch/io/config_yaml.py) against
the JAX package's (the YAML cases of tests/test_config_convert.py): the same
files load to equal configs in both packages, and dump_slam_config writes
the same text, character for character. PyYAML is optional in the port
(the machine with the card lacks it): these cases skip without it."""
import dataclasses

import pytest

yaml = pytest.importorskip("yaml", reason="PyYAML is not installed")

from slide_slam_tpu import config as jconfig  # noqa: E402
from slide_slam_tpu.io import config_yaml as jyaml  # noqa: E402
from slide_slam_tpu_torch import config  # noqa: E402
from slide_slam_tpu_torch.io.config_yaml import (  # noqa: E402
    dump_slam_config, load_class_info, load_slam_config)

SLOAM_YAML = """
sloam:
  use_slidematch: true
  communication_wait_time: 7.5
  cylinder_match_thresh: 2.5
  number_of_robots: 4
  place_recognition:
    search_xy_step_size: 0.2
    min_num_inliers: 12
  place_recognition_slidegraph:
    sigma: 0.05
  factor_graph:
    noise_model_odom_vec: [0.2, 0.2, 0.2, 0.1, 0.1, 0.1]
  capacity:
    max_poses_per_robot: 256
  solver:
    pcg_max_iterations: 64
"""

CLASSES_YAML = """
classes:
  car:
    id: 5
    model: cuboid
    dim_lo: [2.0, 1.0, 0.8]
    dim_hi: [7.0, 3.0, 2.5]
  tree:
    id: 8
    model: cylinder
    eps_cluster: 0.8
pipeline:
  max_range: 25.0
"""


def test_slam_config_roundtrip(tmp_path):
    p = tmp_path / "sloam.yaml"
    p.write_text(SLOAM_YAML)
    cfg = load_slam_config(str(p))
    assert isinstance(cfg, config.SlamConfig)
    assert cfg.use_slidematch is True
    assert cfg.communication_wait_time == 7.5
    assert cfg.cylinder_match_thresh == 2.5
    assert cfg.number_of_robots == 4
    assert cfg.place_recognition.search_xy_step_size == 0.2
    assert cfg.place_recognition.min_num_inliers == 12
    assert cfg.slidegraph.sigma == 0.05
    assert cfg.noise.odom == (0.2, 0.2, 0.2, 0.1, 0.1, 0.1)
    assert cfg.capacity.max_poses_per_robot == 256
    assert cfg.solver.pcg_max_iterations == 64

    # round trip, and the same config as the JAX package's loader
    text = dump_slam_config(cfg)
    p2 = tmp_path / "dump.yaml"
    p2.write_text(text)
    assert load_slam_config(str(p2)) == cfg
    jcfg = jyaml.load_slam_config(str(p))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jyaml.dump_slam_config(jcfg) == text


@pytest.mark.parametrize("preset", ["default", "forest", "indoor"])
def test_dump_text_equals_jax(preset):
    """dump_slam_config of each preset: the JAX package's text exactly."""
    ours = {"default": config.SlamConfig, "forest": config.forest_config,
            "indoor": config.indoor_config}[preset]()
    theirs = {"default": jconfig.SlamConfig,
              "forest": jconfig.forest_config,
              "indoor": jconfig.indoor_config}[preset]()
    assert dump_slam_config(ours) == jyaml.dump_slam_config(theirs)


def test_class_info_yaml(tmp_path):
    p = tmp_path / "classes.yaml"
    p.write_text(CLASSES_YAML)
    cfg = load_class_info(str(p))
    assert cfg.max_range == 25.0
    by_name = {c.name: c for c in cfg.classes}
    assert by_name["car"].label == 5 and by_name["car"].dim_lo == (2.0, 1.0, 0.8)
    assert by_name["tree"].model == "cylinder"
    jcfg = jyaml.load_class_info(str(p))
    assert [dataclasses.asdict(c) for c in cfg.classes] == [
        dataclasses.asdict(c) for c in jcfg.classes]
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "classes"} == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
        if f.name != "classes"}
