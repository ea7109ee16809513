"""Deployment export: the save_jit.py equivalent.

Counterpart of dwbc_tpu/runner/export.py. The reference traces the bare
Actor and StateHistoryEncoder with torch.jit for the robot runtime
(save_jit.py:196-236); the JAX package writes msgpack weights and
StableHLO modules. Here, into --out_dir:
  * actor_critic.pt: the weights, one torch.save state dict;
  * policy.pt2 and hist_encoder.pt2: torch.export programs of
    act_mean(obs, True) (the deployment-mode actor, history-encoder latent
    path) and hist_latent(obs), each with a dynamic batch dimension (the
    robot runtime calls with batch 1, eval playback with num_envs);
  * export.json: the device the programs were captured on and the
    observation width.
A program captured on the card runs on the card: `load_artifact` refuses
to run it on the CPU (and a CPU program on the card) and says so.

Usage: python -m dwbc_tpu_torch.runner.export --task go1 --checkpoint path
       --out_dir dir [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch import nn

from ..utils.device import resolve_device

PROGRAMS = {"policy": "policy.pt2", "hist_encoder": "hist_encoder.pt2"}


class _ActMean(nn.Module):
    """act_mean with the history-encoder latent baked in."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, obs):
        return self.model.act_mean(obs, True)


class _HistLatent(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, obs):
        return self.model.hist_latent(obs)


def export_model(model: nn.Module, num_obs: int, out_dir: str) -> dict:
    """Write the weights, the two programs and export.json for `model` on
    its own device. Returns the seconds each program took to capture."""
    device = next(model.parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(out_dir, "actor_critic.pt"))
    # an example batch of 2: a batch of 1 would specialise the dimension
    example = torch.zeros((2, num_obs), device=device)
    batch = torch.export.Dim("batch", min=1)
    seconds = {}
    for name, wrapper in (("policy", _ActMean), ("hist_encoder", _HistLatent)):
        t0 = time.time()
        program = torch.export.export(wrapper(model).eval(), (example,),
                                      dynamic_shapes={"obs": {0: batch}})
        torch.export.save(program, os.path.join(out_dir, PROGRAMS[name]))
        seconds[name] = time.time() - t0
    with open(os.path.join(out_dir, "export.json"), "w") as f:
        json.dump({"device": device.type, "num_obs": num_obs}, f)
    return seconds


def load_artifact(export_dir: str, name: str = "policy", device="cuda"):
    """The exported program `name` ("policy" or "hist_encoder") as a
    callable obs -> output on `device`. Raises if it was captured on
    another device type."""
    dev = resolve_device(device)
    with open(os.path.join(export_dir, "export.json")) as f:
        captured = json.load(f)["device"]
    if captured != dev.type:
        raise RuntimeError(
            f"{export_dir} was exported on {captured} and runs there only; "
            f"export it again with the runner on {dev.type} to run it there")
    return torch.export.load(os.path.join(export_dir, PROGRAMS[name])).module()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="widowGo1")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out_dir", default="export")
    ap.add_argument("--cpu", action="store_true",
                    help="export on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    from ..utils.task_registry import make_runner

    env, runner, _ = make_runner(args.task, num_envs=1,
                                 device="cpu" if args.cpu else "cuda")
    runner.load(args.checkpoint, load_optimizer=False)
    seconds = export_model(runner.model, env.num_obs, args.out_dir)
    print(f"exported weights + torch.export programs ({env.device}) to "
          f"{args.out_dir} in {sum(seconds.values()):.2f} s")
    return seconds


if __name__ == "__main__":
    main()
