"""Carry weights and state in from numpy (for instance from the JAX
package, converted with np.asarray). Takes numpy arrays only."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .envs.widowgo1 import EnvState
from .models.actor_critic import ActorCritic
from .rl.ppo import PPOState
from .sim import dynamics, engine
from .utils.device import resolve_device


def _dense_leaves(layer: torch.nn.Linear, leaf: Mapping):
    # flax Dense kernels are (in, out); nn.Linear weights are (out, in)
    yield layer.weight, np.array(leaf["kernel"]).T
    yield layer.bias, np.array(leaf["bias"])


def _conv_leaves(layer: torch.nn.Conv1d, leaf: Mapping):
    # flax Conv kernels are (k, in, out) on NLC data; Conv1d (out, in, k)
    yield layer.weight, np.array(leaf["kernel"]).transpose(2, 1, 0)
    yield layer.bias, np.array(leaf["bias"])


def _history_leaves(h: Mapping, model: ActorCritic):
    """(torch parameter, numpy array in the parameter's layout) for every
    leaf of the history encoder's flax subtree."""
    enc = model.actor.history_encoder
    yield from _dense_leaves(enc.proj, h["Dense_0"])
    for i, conv in enumerate(enc.convs):
        yield from _conv_leaves(conv, h[f"Conv_{i}"])
    yield from _dense_leaves(enc.out, h["Dense_1"])


def _flax_leaves(tree: Mapping, model: ActorCritic):
    """The same pairs for every leaf of a flax ActorCritic tree
    ({"params": {...}} or the inner dict): the weights themselves, or any
    tree of their shape such as Adam's moments."""
    p = tree.get("params", tree)
    a, c = p["actor"], p["critic"]
    actor, critic = model.actor, model.critic
    for prefix, layers in (("priv_encoder_layers", actor.priv_encoder_layers),
                           ("backbone_layers", actor.backbone_layers),
                           ("leg_layers", actor.leg_layers),
                           ("arm_layers", actor.arm_layers)):
        for i, layer in enumerate(layers):
            yield from _dense_leaves(layer, a[f"{prefix}_{i}"])
    yield from _history_leaves(a["history_encoder"], model)
    # the flax Critic names its Dense layers in creation order: backbone,
    # then the leg head, then the arm head
    critic_layers = (list(critic.backbone_layers) + list(critic.leg_layers)
                     + list(critic.arm_layers))
    for i, layer in enumerate(critic_layers):
        yield from _dense_leaves(layer, c[f"Dense_{i}"])
    yield model.std, np.array(p["std"])


@torch.no_grad()
def actor_critic_from_flax(params_np: Mapping, model: ActorCritic) -> ActorCritic:
    """Load a flax ActorCritic parameter tree ({"params": {...}} or the
    inner dict, leaves as numpy arrays) into `model` in place; with
    adaptive arm gains the 12-wide arm head carries over like any layer."""
    for param, value in _flax_leaves(params_np, model):
        param.copy_(torch.as_tensor(value))
    return model


@torch.no_grad()
def ppo_state_from_numpy(tree: Mapping, state: PPOState) -> PPOState:
    """Load a JAX PPOState, given as numpy arrays, into `state` in place.

    `tree` has the keys
      params:        the flax parameter tree;
      opt:           {"mu", "nu": trees shaped like params, "count"} of the
                     main chain's Adam;
      hist_opt:      {"mu", "nu": the history_encoder subtree, "count"} of
                     the history-encoder chain's Adam;
      learning_rate, counter.
    Adam's mu becomes exp_avg, nu exp_avg_sq and count step, with the
    same transposes as the weights."""
    model = state.model
    actor_critic_from_flax(tree["params"], model)

    def load(opt, adam, leaves):
        mu = {id(p): v for p, v in leaves(adam["mu"], model)}
        nu = {id(p): v for p, v in leaves(adam["nu"], model)}
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = dict(
                    step=torch.tensor(float(np.asarray(adam["count"]))),
                    exp_avg=torch.as_tensor(
                        mu[id(p)], device=p.device).contiguous(),
                    exp_avg_sq=torch.as_tensor(
                        nu[id(p)], device=p.device).contiguous())

    load(state.opt, tree["opt"], _flax_leaves)
    load(state.hist_opt, tree["hist_opt"], _history_leaves)
    state.learning_rate = float(np.asarray(tree["learning_rate"]))
    state.counter = int(np.asarray(tree["counter"]))
    return state


def env_state_from_numpy(tree: Mapping, device="cuda") -> EnvState:
    """An EnvState from a nested dict of numpy arrays keyed by EnvState's
    field names (robot/box: {q, qd}; inert/box_inert: {mass, com,
    inertia}; contact_carry, episode_sums, metric_sums: dicts). Floats
    become float32, episode_length int32, the flag arrays bool; the
    state's generator is a fresh torch.Generator on `device` seeded with 0
    (random streams do not carry over between frameworks)."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    kw = {}
    for f in EnvState.__dataclass_fields__:
        v = tree[f] if f != "generator" else None
        if f in ("robot", "box"):
            kw[f] = engine.BodyState(q=t(v["q"]), qd=t(v["qd"]))
        elif f in ("inert", "box_inert"):
            kw[f] = dynamics.Inertial(mass=t(v["mass"]), com=t(v["com"]),
                                      inertia=t(v["inertia"]))
        elif f in ("contact_carry", "episode_sums", "metric_sums"):
            kw[f] = {k: t(x) for k, x in v.items()}
        elif f == "generator":
            kw[f] = torch.Generator(device=dev)
            kw[f].manual_seed(0)
        elif f == "common_step":
            kw[f] = int(np.asarray(v))
        elif f == "episode_length":
            kw[f] = t(v, torch.int32)
        elif f in ("last_contacts", "reset_buf", "time_out_buf"):
            kw[f] = t(v, torch.bool)
        else:
            kw[f] = t(v)
    return EnvState(**kw)
