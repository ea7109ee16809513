"""The port's public builders and entry points run on `cuda` unless the
caller passes device="cpu" (or --cpu): called without a device on a
machine without a card, each raises instead of quietly building CPU
tensors."""

import numpy as np
import pytest
import torch

from dwbc_tpu_torch.core import maths
from dwbc_tpu_torch.core.model import free_body_model
from dwbc_tpu_torch.envs import legged_config
from dwbc_tpu_torch.envs.legged_robot import LeggedRobotEnv
from dwbc_tpu_torch.models import actuator_net
from dwbc_tpu_torch.parallel import dryrun
from dwbc_tpu_torch.runner import export, play
from dwbc_tpu_torch.sim import dynamics, engine, fused
from dwbc_tpu_torch.terrain import terrain

SMALL = terrain.PerlinTerrainCfg(tot_cols=240, tot_rows=400)
BOX = free_body_model("box", 1.0, (0.05,) * 3)

BUILDERS = {
    "flat_plane": lambda: terrain.flat_plane(),
    "perlin_terrain": lambda: terrain.perlin_terrain(SMALL),
    "heightfield_from_numpy": lambda: terrain.heightfield_from_numpy(
        np.zeros((4, 4)), 0.025, (0.0, 0.0)),
    "init_contact_carry": lambda: fused.init_contact_carry(BOX, 4),
    "default_inertial": lambda: dynamics.default_inertial(BOX),
    # the device is resolved before any other argument is used
    "make_fused_substep": lambda: fused.make_fused_substep(
        BOX, engine.SimParams(), None, None, []),
    "grid_terrain": lambda: terrain.grid_terrain(
        terrain.GridTerrainCfg(num_rows=1, num_cols=1, border_size=1.0)),
    "LeggedRobotEnv": lambda: LeggedRobotEnv(legged_config.go1_flat(), 4),
    "actuator_net.load_params": lambda: actuator_net.load_params(),
    "actuator_net.init_hidden": lambda: actuator_net.init_hidden(4),
    "quat_identity": lambda: maths.quat_identity((2,)),
    "export.main": lambda: export.main(["--task", "go1_flat",
                                        "--checkpoint", "unused"]),
    "export.load_artifact": lambda: export.load_artifact("unused"),
    "play.main": lambda: play.main(["--task", "go1_flat", "--steps", "1"]),
    "dryrun": lambda: dryrun.main(["2"]),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_defaults_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        BUILDERS[name]()

