"""Recurrent PPO in rsl_rl's formulation, in plain float32 torch: the
rollout stores the hidden state at every step, and the update splits
each env's trajectory at its dones, pads the pieces to one length,
unrolls every piece from the hidden state stored at its first step,
unpads, and averages the loss over the same elements as the rollout
holds (rsl_rl/algorithms/ppo.py, storage/rollout_storage.py
reccurent_mini_batch_generator, utils/utils.py
split_and_pad_trajectories and unpad_trajectories).

Written for the benchmark from rsl_rl's description, not copied from the
program: it is an independent check of the program's claim that a
masked re-unroll of the whole trajectory from the collect's first carry
computes the same loss and gradients. It takes the reference's own GAE,
adaptive-KL rule, gradient clipping and Adam step (rl/ppo.py), which the
feedforward path shares. Departures from rsl_rl, each on purpose:
  * minibatches are sets of envs drawn by one permutation per update
    from the minibatch generator, as the program draws them, where
    rsl_rl takes the envs in order: the same envs on both sides;
  * the bootstrap value of the last observation is the critic's step
    from the reset carry, which is then discarded: rsl_rl's `evaluate`
    advances the critic's memory by that step, which the program does
    not do;
  * the collect returns the carry before the reset of the last step's
    dones (the program's runner keeps it so), and resets it as the next
    collect starts;
  * `update` steps with the program's clipped gradients where a
    follower hands them over (the entry's module docstring says why),
    after taking its own gradients' norms, and at the rate its own KL
    chose.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from ..models import actor_critic as ac_lib
from ..models.actor_critic_recurrent import ActorCriticRecurrent, reset
from . import ppo as ppo_lib
from .runner import rank_generators


class RecurrentTransition(NamedTuple):
    obs: torch.Tensor         # (T, N, D)
    actions: torch.Tensor     # (T, N, A)
    rewards: torch.Tensor     # (T, N, 1)
    dones: torch.Tensor       # (T, N) episode ended with this step
    dones_prev: torch.Tensor  # (T, N) episode ended with the step before
    time_outs: torch.Tensor   # (T, N)
    values: torch.Tensor      # (T, N, 1)
    log_probs: torch.Tensor   # (T, N, 1)
    mu: torch.Tensor
    sigma: torch.Tensor
    # (T, N, 4, H): the carry each step started from, after its reset:
    # the actor's c and h, the critic's c and h. A trajectory taken up
    # from the program has none until the reference re-steps it.
    hidden: Optional[torch.Tensor] = None


def _stack(carry) -> torch.Tensor:
    (ca, ha), (cc, hc) = carry
    return torch.stack([ca, ha, cc, hc], 1)


def _unstack(h: torch.Tensor):
    return ((h[:, 0], h[:, 1]), (h[:, 2], h[:, 3]))


def split_and_pad(dones: torch.Tensor):
    """The pieces of (T, N) trajectories cut after every done:
    (starts (T, N), the steps at which a piece begins; index (T, N) of
    each step's place in the padded (T, S) layout, as a flat index; and
    masks (T, S), True where a padded place holds a step). Pieces are
    ordered env by env, and in time within an env."""
    T, N = dones.shape
    starts = torch.ones_like(dones)
    starts[1:] = dones[:-1]
    # piece of every step, numbered env-major
    piece = torch.cumsum(starts.t().reshape(-1).long(), 0) - 1
    piece = piece.view(N, T).t()
    first = torch.arange(T, device=dones.device)[:, None].expand(T, N)
    # each piece's first step, spread over the piece's steps
    begin = torch.zeros(int(piece.max()) + 1, dtype=torch.long,
                        device=dones.device)
    begin[piece[starts]] = first[starts]
    pos = first - begin[piece]
    S = begin.shape[0]
    masks = torch.zeros((T, S), dtype=torch.bool, device=dones.device)
    masks[pos, piece] = True
    return starts, pos * S + piece, masks


def pad(x: torch.Tensor, index: torch.Tensor, S: int) -> torch.Tensor:
    """(T, N, ...) steps into the padded (T, S, ...) layout, zeros in the
    padding."""
    T = x.shape[0]
    out = x.new_zeros((T * S,) + x.shape[2:])
    out[index.reshape(-1)] = x.reshape((-1,) + x.shape[2:])
    return out.view((T, S) + x.shape[2:])


def unpad(y: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The padded (T, S, ...) back to the steps' (T, N, ...) layout."""
    flat = y.reshape((-1,) + y.shape[2:])
    return flat[index.reshape(-1)].view(index.shape + y.shape[2:])


class RecurrentPPO:
    def __init__(self, env, model: ActorCriticRecurrent,
                 cfg: ppo_lib.PPOConfig, num_steps: int = 24):
        self.env = env
        self.model = model
        self.cfg = cfg
        self.num_steps = num_steps

    @torch.no_grad()
    def policy_step(self, hidden, obs, gen: torch.Generator):
        """(hidden', mean, value, sampled actions, their log-probability)
        from a reset carry."""
        model = self.model
        hidden, mean, value = model.step(hidden, obs)
        actions = ac_lib.normal_sample(gen, mean, model.std)
        return (hidden, mean, value, actions,
                ppo_lib.logp_heads(self.cfg, actions, mean, model.std))

    @torch.no_grad()
    def bootstrap(self, carry, dones, obs):
        """The critic's value of the last observation, from the carry
        reset where the last step ended an episode."""
        return self.model.step(reset(carry, dones), obs)[2]

    @torch.no_grad()
    def collect(self, env_state, obs, carry, last_dones,
                gen: torch.Generator):
        """num_steps of (policy -> env.step) from `carry`, reset first
        where `last_dones` is set. Returns (env_state, obs, carry before
        the last reset, the last dones, traj, last values)."""
        hidden = reset(carry, last_dones)
        dprev = last_dones
        steps = []
        for _ in range(self.num_steps):
            start = _stack(hidden)
            carry, mean, value, actions, logp = self.policy_step(hidden, obs,
                                                                 gen)
            env_state, out = self.env.step(env_state, actions)
            steps.append((obs, actions, out.rew[..., None], out.reset, dprev,
                          out.time_outs, value, logp, mean, start))
            hidden = reset(carry, out.reset)
            obs, dprev = out.obs, out.reset
        cols = [torch.stack(c) for c in zip(*steps)]
        sigma = self.model.std.expand_as(cols[8]).clone()
        traj = RecurrentTransition(*cols[:9], sigma, cols[9])
        return (env_state, obs, carry, dprev, traj,
                self.bootstrap(carry, dprev, obs))

    def update(self, state: ppo_lib.PPOState, traj: RecurrentTransition,
               last_values, gen: Optional[torch.Generator] = None,
               program_grads: Optional[Sequence[Dict]] = None):
        """GAE, then num_learning_epochs x num_mini_batches gradient
        steps over minibatches of envs, each unrolling the padded pieces
        of its envs' trajectories from their stored hidden states.
        Changes `state` in place and returns the mean losses.

        `program_grads`, where given, holds each step's clipped
        gradients ({name: tensor}) as the program took them (a
        follower's, benchmark/entries/recurrent.py): each step then
        clips its own gradients, keeps their norms (`grad_norms` in the
        result, {name: norm} a step) and steps with the program's, at the
        rate its own KL chose."""
        cfg, model = self.cfg, self.model
        with torch.no_grad():
            returns, advantages = ppo_lib.compute_gae(cfg, traj, last_values)
        T, N = traj.dones.shape
        nmb = cfg.num_mini_batches
        mb = N // nmb
        dev = traj.obs.device
        envs = ppo_lib._permutation(N, gen, None, dev)[:nmb * mb] \
            .reshape(nmb, mb)
        adaptive_lr = cfg.desired_kl is not None and cfg.schedule == "adaptive"
        # the pieces of every minibatch: the same in every epoch
        cuts = []
        for idx in envs:
            starts, index, masks = split_and_pad(traj.dones[:, idx])
            # the stored hidden state at each piece's first step, env-major
            h0 = traj.hidden[:, idx].transpose(0, 1)[starts.t()]
            cuts.append((idx, index, masks.shape[1], _unstack(h0)))

        value_loss = torch.zeros((), device=dev)
        surrogate_loss = torch.zeros((), device=dev)
        lr = state.learning_rate
        grad_norms = []
        named = list(model.named_parameters())
        for _ in range(cfg.num_learning_epochs):
            for idx, index, S, (ha, hc) in cuts:
                state.opt.zero_grad(set_to_none=False)
                obs = pad(traj.obs[:, idx], index, S)
                mean = model.actor(unpad(model.memory_a.sequence(ha, obs),
                                         index))
                value = model.critic(unpad(model.memory_c.sequence(hc, obs),
                                           index))
                std = model.std
                ratio = torch.exp(
                    ppo_lib.logp_heads(cfg, traj.actions[:, idx], mean, std)
                    - traj.log_probs[:, idx])
                adv = advantages[:, idx]
                surrogate = torch.maximum(
                    -adv * ratio,
                    -adv * torch.clamp(ratio, 1 - cfg.clip_param,
                                       1 + cfg.clip_param)).mean()
                old_v, ret = traj.values[:, idx], returns[:, idx]
                v_clip = old_v + torch.clamp(value - old_v, -cfg.clip_param,
                                             cfg.clip_param)
                v_loss = torch.maximum(torch.square(value - ret),
                                       torch.square(v_clip - ret)).mean()
                entropy = (0.5 + 0.5 * math.log(2 * math.pi)
                           + torch.log(std)).sum()
                loss = (surrogate + cfg.value_loss_coef * v_loss
                        - cfg.entropy_coef * entropy)
                loss.backward()
                if adaptive_lr:
                    with torch.no_grad():
                        sigma, mu = traj.sigma[:, idx], traj.mu[:, idx]
                        kl = torch.sum(
                            torch.log(std / sigma + 1e-5)
                            + (torch.square(sigma) + torch.square(mu - mean))
                            / (2.0 * torch.square(std)) - 0.5, dim=-1)
                    lr = ppo_lib.adapt_learning_rate(cfg, lr,
                                                     kl.mean().item())
                if program_grads is None:
                    ppo_lib._adam_step(state.opt, state.params,
                                       cfg.max_grad_norm, lr)
                else:
                    grads = program_grads[len(grad_norms)]
                    ppo_lib._clip_by_global_norm(
                        [p.grad for _, p in named], cfg.max_grad_norm)
                    grad_norms.append({k: torch.linalg.vector_norm(
                        p.grad, dtype=torch.float64) for k, p in named})
                    with torch.no_grad():
                        for k, p in named:
                            p.grad.copy_(grads[k])
                    for group in state.opt.param_groups:
                        group["lr"] = lr
                    state.opt.step()
                value_loss = value_loss + v_loss.detach()
                surrogate_loss = surrogate_loss + surrogate.detach()
        n = cfg.num_learning_epochs * nmb
        state.learning_rate = lr
        state.counter += 1
        return {"value_loss": value_loss / n,
                "surrogate_loss": surrogate_loss / n,
                "grad_norms": grad_norms}


class RecurrentRunner:
    """One process, the env's device: collect, then update, per
    iteration, with the program's runner's random streams and
    attributes (env_state, obs, carry, last_dones, last_traj and the two
    timers' places)."""

    def __init__(self, env, cfg: ppo_lib.PPOConfig, num_steps_per_env=24,
                 seed: int = 1, *, rnn_hidden_size: int,
                 actor_hidden_dims, critic_hidden_dims,
                 activation: str = "elu", init_noise_std: float = 1.0):
        self.env = env
        self.device = dev = env.device
        self.model = ActorCriticRecurrent(
            env.num_obs, env.num_actions, rnn_hidden_size,
            actor_hidden_dims, critic_hidden_dims, activation,
            init_noise_std).to(dev)
        self.ppo_state = ppo_lib.PPOState(cfg, self.model)
        self.alg = RecurrentPPO(env, self.model, cfg, num_steps_per_env)
        env_gen, self.noise_gen, self.perm_gen = rank_generators(dev, seed)
        self.env_state, self.obs = env.reset(env_gen)
        self.carry = self.model.initial_state(env.num_envs)
        self.last_dones = torch.zeros((env.num_envs,), dtype=torch.bool,
                                      device=dev)
        self.last_collection_time = 0.0
        self.last_learn_time = 0.0
        self.last_traj = None

    def learn(self, num_iterations: int, log=None):
        """`num_iterations` of collect and update; `log`, where given,
        takes a line per iteration."""
        for it in range(num_iterations):
            self.last_traj = None
            (self.env_state, self.obs, self.carry, self.last_dones, traj,
             last_values) = self.alg.collect(
                self.env_state, self.obs, self.carry, self.last_dones,
                self.noise_gen)
            m = self.alg.update(self.ppo_state, traj, last_values,
                                self.perm_gen)
            self.last_traj = traj
            if log is not None:
                log(f"recurrent it {it} value loss {float(m['value_loss'])}")

    def close(self):
        pass
