"""Carry weights and state in from numpy (for instance from the JAX
package, converted with np.asarray). Takes numpy arrays only."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .envs.legged_robot import LeggedState
from .envs.widowgo1 import EnvState
from .models.actor_critic import ActorCritic
from .models.actor_critic_recurrent import ActorCriticRecurrent
from .models.mlp_actor_critic import MlpActorCritic
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


def _mlp_leaves(tree: Mapping, model: MlpActorCritic):
    """The pairs for a flax MlpActorCritic tree."""
    p = tree.get("params", tree)
    for prefix, layers in (("actor_layers", model.actor_layers),
                           ("critic_layers", model.critic_layers)):
        for i, layer in enumerate(layers):
            yield from _dense_leaves(layer, p[f"{prefix}_{i}"])
    yield model.std, np.array(p["std"])


def _cell_leaves(cell, leaf: Mapping, rnn_type: str):
    """A flax OptimizedLSTMCell's / GRUCell's per-gate Dense leaves,
    concatenated into the port cell's stacked Linear layers."""
    def stack(names, what):
        return np.concatenate([np.array(leaf[n][what]) for n in names], -1)

    if rnn_type == "lstm":
        yield cell.wi.weight, stack(("ii", "if", "ig", "io"), "kernel").T
        yield cell.wh.weight, stack(("hi", "hf", "hg", "ho"), "kernel").T
        yield cell.wh.bias, stack(("hi", "hf", "hg", "ho"), "bias")
    else:
        yield cell.wi.weight, stack(("ir", "iz", "in"), "kernel").T
        yield cell.wi.bias, stack(("ir", "iz", "in"), "bias")
        yield cell.wh.weight, stack(("hr", "hz"), "kernel").T
        yield from _dense_leaves(cell.whn, leaf["hn"])


def _recurrent_leaves(tree: Mapping, model: ActorCriticRecurrent):
    """The pairs for a flax ActorCriticRecurrent tree."""
    p = tree.get("params", tree)
    yield from _cell_leaves(model.memory_a, p["memory_a"], model.rnn_type)
    yield from _cell_leaves(model.memory_c, p["memory_c"], model.rnn_type)
    for prefix, layers in (("actor_layers", model.actor_layers),
                           ("critic_layers", model.critic_layers)):
        for i, layer in enumerate(layers):
            yield from _dense_leaves(layer, p[f"{prefix}_{i}"])
    yield model.std, np.array(p["std"])


def _leaves_of(model):
    """The leaf-pairing function for the model's class."""
    for cls, fn in ((ActorCritic, _flax_leaves), (MlpActorCritic, _mlp_leaves),
                    (ActorCriticRecurrent, _recurrent_leaves)):
        if isinstance(model, cls):
            return fn
    raise TypeError(f"no flax layout known for {type(model).__name__}")


@torch.no_grad()
def _load_leaves(params_np: Mapping, model):
    for param, value in _leaves_of(model)(params_np, model):
        param.copy_(torch.as_tensor(np.ascontiguousarray(value)))
    return model


def mlp_actor_critic_from_flax(params_np: Mapping,
                               model: MlpActorCritic) -> MlpActorCritic:
    """Load a flax MlpActorCritic parameter tree into `model` in place."""
    return _load_leaves(params_np, model)


def recurrent_from_flax(params_np: Mapping,
                        model: ActorCriticRecurrent) -> ActorCriticRecurrent:
    """Load a flax ActorCriticRecurrent parameter tree (LSTM or GRU, as
    the model's rnn_type says) into `model` in place."""
    return _load_leaves(params_np, model)


def actor_critic_from_flax(params_np: Mapping, model: ActorCritic) -> ActorCritic:
    """Load a flax ActorCritic parameter tree ({"params": {...}} or the
    inner dict, leaves as numpy arrays) into `model` in place; with
    adaptive arm gains the 12-wide arm head carries over like any layer."""
    return _load_leaves(params_np, model)


@torch.no_grad()
def ppo_state_from_numpy(tree: Mapping, state: PPOState) -> PPOState:
    """Load a JAX PPOState, given as numpy arrays, into `state` in place.

    `tree` has the keys
      params:        the flax parameter tree;
      opt:           {"mu", "nu": trees shaped like params, "count"} of the
                     main chain's Adam;
      hist_opt:      {"mu", "nu": the history_encoder subtree, "count"} of
                     the history-encoder chain's Adam (not read for a model
                     without a history encoder, whose state has no second
                     optimizer);
      learning_rate, counter.
    Adam's mu becomes exp_avg, nu exp_avg_sq and count step, with the
    same transposes as the weights."""
    model = state.model
    _load_leaves(tree["params"], model)

    def load(opt, adam, leaves):
        mu = {id(p): v for p, v in leaves(adam["mu"], model)}
        nu = {id(p): v for p, v in leaves(adam["nu"], model)}
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = dict(
                    step=torch.tensor(float(np.asarray(adam["count"]))),
                    exp_avg=torch.as_tensor(np.ascontiguousarray(
                        mu[id(p)]), device=p.device),
                    exp_avg_sq=torch.as_tensor(np.ascontiguousarray(
                        nu[id(p)]), device=p.device))

    load(state.opt, tree["opt"], _leaves_of(model))
    if state.hist_opt is not None:
        load(state.hist_opt, tree["hist_opt"], _history_leaves)
    state.learning_rate = float(np.asarray(tree["learning_rate"]))
    state.counter = int(np.asarray(tree["counter"]))
    return state


_BOOL_FIELDS = ("last_contacts", "reset_buf", "time_out_buf")
_DICT_FIELDS = ("contact_carry", "episode_sums", "metric_sums")


def _state_from_numpy(cls, tree: Mapping, device, special: Mapping):
    """`cls` (a state dataclass) from a nested dict of numpy arrays keyed
    by its field names. Floats become float32, the flag arrays bool,
    body states and inertials their named tuples; `special` maps a field
    name to its own converter. The generator is a fresh torch.Generator
    on `device` seeded with 0 (random streams do not carry over between
    frameworks)."""
    dev = resolve_device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    kw = {}
    for f in cls.__dataclass_fields__:
        v = tree[f] if f != "generator" else None
        if f in special:
            kw[f] = special[f](v, t)
        elif f in ("robot", "box"):
            kw[f] = engine.BodyState(q=t(v["q"]), qd=t(v["qd"]))
        elif f in ("inert", "box_inert"):
            kw[f] = dynamics.Inertial(mass=t(v["mass"]), com=t(v["com"]),
                                      inertia=t(v["inertia"]))
        elif f in _DICT_FIELDS:
            kw[f] = {k: t(x) for k, x in v.items()}
        elif f == "generator":
            kw[f] = torch.Generator(device=dev)
            kw[f].manual_seed(0)
        elif f == "episode_length":
            kw[f] = t(v, torch.int32)
        elif f in _BOOL_FIELDS:
            kw[f] = t(v, torch.bool)
        else:
            kw[f] = t(v)
    return cls(**kw)


def env_state_from_numpy(tree: Mapping, device="cuda") -> EnvState:
    """An EnvState from a nested dict of numpy arrays keyed by EnvState's
    field names (robot/box: {q, qd}; inert/box_inert: {mass, com,
    inertia}; contact_carry, episode_sums, metric_sums: dicts); see
    _state_from_numpy. common_step becomes a Python int."""
    return _state_from_numpy(
        EnvState, tree, device,
        {"common_step": lambda v, t: int(np.asarray(v))})


def legged_state_from_numpy(tree: Mapping, device="cuda") -> LeggedState:
    """A LeggedState from a nested dict of numpy arrays keyed by
    LeggedState's field names (the JAX state's `key` is not read); see
    _state_from_numpy. common_step, terrain_levels and terrain_types
    become int64 tensors."""
    as_long = lambda v, t: t(v, torch.long)
    return _state_from_numpy(
        LeggedState, tree, device,
        {"common_step": as_long, "terrain_levels": as_long,
         "terrain_types": as_long})
