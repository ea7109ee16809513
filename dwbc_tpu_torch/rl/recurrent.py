"""Recurrent PPO training path (BPTT) on torch tensors.

Counterpart of dwbc_tpu/rl/recurrent.py. The reference trains LSTM
policies by storing per-step hidden states in transitions (rsl_rl
algorithms/ppo.py:115-127) and re-forwarding padded per-trajectory
minibatches (rollout_storage.py:208-257 + utils/utils.py:33-71
split_and_pad_trajectories). The formulation here is simpler and
equivalent: the rollout carries the hidden state explicitly, resetting it
where episodes end, and the update re-unrolls the whole (T, N) trajectory
from the SAME initial carry with the same done masks, with autograd
through the unroll (the hidden state is zero after every done either
way). Minibatching is over the env dimension, which never splits a
trajectory.

Data parallelism as in rl/runner.py: inside a process group each rank of
a torch.distributed job steps its own share of the envs, minibatches its
local envs, and averages gradients and the KL over the ranks per
minibatch; GAE normalises with the job's advantage mean and std.
"""

from __future__ import annotations

import json
import math
import os
from typing import NamedTuple, Optional

import torch

from ..models.actor_critic_recurrent import ActorCriticRecurrent, _map_carry
from ..parallel import distributed as dist
from ..parallel import mesh
from ..utils import device as device_lib
from ..utils import spans
from . import ppo as ppo_lib
from .runner import rank_generators


class RecurrentTransition(NamedTuple):
    obs: torch.Tensor         # (T, N, D)
    actions: torch.Tensor     # (T, N, A)
    rewards: torch.Tensor     # (T, N, 1)
    dones: torch.Tensor       # (T, N) reset flags AFTER this step
    dones_prev: torch.Tensor  # (T, N) reset flags BEFORE this step (carry mask)
    time_outs: torch.Tensor   # (T, N)
    values: torch.Tensor      # (T, N, 1)
    log_probs: torch.Tensor   # (T, N, 1)
    mu: torch.Tensor
    sigma: torch.Tensor


def _logp(actions, mean, std):
    lp = (-0.5 * torch.square((actions - mean) / std) - torch.log(std)
          - 0.5 * math.log(2 * math.pi))
    return lp.sum(-1, keepdim=True)


class RecurrentPPO:
    """Rollout + BPTT update for ActorCriticRecurrent over a VecEnv-style
    env (single-head action space, locomotion family)."""

    def __init__(self, env, model: ActorCriticRecurrent,
                 cfg: ppo_lib.PPOConfig, num_steps: int = 24):
        if cfg.num_heads != 1:
            raise ValueError("the recurrent path is single-head")
        self.env = env
        self.model = model
        self.cfg = cfg
        self.num_steps = num_steps

    def init_carry(self, num_envs: int):
        return self.model.initial_state(num_envs)

    # -- rollout -------------------------------------------------------

    @torch.no_grad()
    def collect(self, env_state, obs, carry, last_dones,
                gen: torch.Generator):
        """num_steps of (model.step -> env.step) from `carry`, whose rows
        are reset where `last_dones` is set. Returns (env_state, obs,
        carry, last_dones, traj, last_values, ep_stats, nres); `gen` draws
        the action noise."""
        env, model = self.env, self.model
        dev = obs.device
        std = model.std
        dprev = last_dones
        ep_stats = {"reward_sum": torch.zeros((), device=dev),
                    "len_sum": torch.zeros((), device=dev)}
        nres = torch.zeros((), dtype=torch.int64, device=dev)
        steps = []
        for _ in range(self.num_steps):
            with spans.span("rollout.policy"):
                carry, mean, value = model.step(carry, obs, dprev)
                actions = mean + std * torch.randn(mean.shape, generator=gen,
                                                   device=dev)
                logp = _logp(actions, mean, std)
            env_state, out = env.step(env_state, actions)
            steps.append((obs, actions, out.rew[..., None], out.reset, dprev,
                          out.time_outs, value, logp, mean))
            # episode bookkeeping on the feedforward family's metric names
            ep_stats = {k: v + out.episode_stats[k]
                        for k, v in ep_stats.items()}
            nres = nres + out.num_resets
            obs, dprev = out.obs, out.reset
        cols = [torch.stack(c) for c in zip(*steps)]
        traj = RecurrentTransition(*cols, std.expand_as(cols[-1]).clone())
        # bootstrap value of the final obs (hidden reset where just done)
        _, _, last_values = model.step(carry, obs, dprev)
        return (env_state, obs, carry, dprev, traj, last_values, ep_stats,
                nres)

    # -- update --------------------------------------------------------

    def update(self, state: ppo_lib.PPOState, traj: RecurrentTransition, h0,
               last_values, gen: Optional[torch.Generator] = None,
               perm: Optional[torch.Tensor] = None):
        """GAE, then num_learning_epochs x num_mini_batches gradient steps,
        each re-unrolling the trajectories of one minibatch of envs from
        their rows of `h0`. The env permutation comes from `gen` unless
        `perm` gives it; the same one serves every epoch. Changes `state`
        in place and returns the metrics."""
        cfg = self.cfg
        model = self.model
        # GAE identical to the feedforward path
        fake = ppo_lib.Transition(
            obs=traj.obs, actions=traj.actions, rewards=traj.rewards,
            dones=traj.dones, time_outs=traj.time_outs, values=traj.values,
            log_probs=traj.log_probs, mu=traj.mu, sigma=traj.sigma,
            target_arm_torques=None, current_arm_dof_pos=None,
            current_arm_dof_vel=None)
        with torch.no_grad():
            returns, advantages = ppo_lib.compute_gae(cfg, fake, last_values)

        T, N = traj.dones.shape
        nmb = cfg.num_mini_batches
        mb_envs = N // nmb
        dev = traj.obs.device
        idx_mat = ppo_lib._permutation(N, gen, perm, dev)[:nmb * mb_envs] \
            .reshape(nmb, mb_envs)
        adaptive_lr = cfg.desired_kl is not None and cfg.schedule == "adaptive"

        def loss_fn(idx):
            carry0 = _map_carry(lambda h: h[idx], h0)
            _, (mean, value) = model.unroll(carry0, traj.obs[:, idx],
                                            traj.dones_prev[:, idx])
            std = model.std
            logp = _logp(traj.actions[:, idx], mean, std)
            adv = advantages[:, idx]
            ratio = torch.exp(logp - traj.log_probs[:, idx])
            surr = -adv * ratio
            surr_c = -adv * torch.clamp(ratio, 1 - cfg.clip_param,
                                        1 + cfg.clip_param)
            surrogate_loss = torch.maximum(surr, surr_c).mean()
            old_v = traj.values[:, idx]
            ret = returns[:, idx]
            v_clip = old_v + torch.clamp(value - old_v, -cfg.clip_param,
                                         cfg.clip_param)
            v_loss = torch.maximum(torch.square(value - ret),
                                   torch.square(v_clip - ret)).mean()
            entropy = (0.5 + 0.5 * math.log(2 * math.pi)
                       + torch.log(std)).sum()
            loss = (surrogate_loss + cfg.value_loss_coef * v_loss
                    - cfg.entropy_coef * entropy)
            with torch.no_grad():
                sigma = traj.sigma[:, idx]
                kl = torch.sum(
                    torch.log(std / sigma + 1e-5)
                    + (torch.square(sigma)
                       + torch.square(traj.mu[:, idx] - mean))
                    / (2.0 * torch.square(std)) - 0.5, dim=-1)
            return loss, dict(value_loss=v_loss.detach(),
                              surrogate_loss=surrogate_loss.detach(),
                              kl_mean=kl.mean())

        keys = ("value_loss", "surrogate_loss")
        totals = {k: torch.zeros((), device=dev) for k in keys}
        lr = state.learning_rate
        for _ in range(cfg.num_learning_epochs):
            for idx in idx_mat:
                with spans.span("ppo.minibatch"):
                    state.opt.zero_grad(set_to_none=False)
                    loss, aux = loss_fn(idx)
                    loss.backward()
                    if dist.active():
                        aux = ppo_lib._mean_over_ranks(state.params, aux)
                    if adaptive_lr:
                        device_lib.host_sync(aux["kl_mean"])
                        lr = ppo_lib.adapt_learning_rate(
                            cfg, lr, aux["kl_mean"].item())
                    ppo_lib._adam_step(state.opt, state.params,
                                       cfg.max_grad_norm, lr)
                    for k in keys:
                        totals[k] = totals[k] + aux[k]
        n = cfg.num_learning_epochs * nmb
        state.learning_rate = lr
        state.counter += 1
        return {k: v / n for k, v in totals.items()}


class RecurrentRunner:
    """Minimal training loop for the recurrent path (the full-featured
    OnPolicyRunner drives the feedforward families). Reachable from the
    train CLI via TaskSpec.policy_class_name == 'ActorCriticRecurrent'
    (the reference's selection mechanism, on_policy_runner.py:63). Runs on
    the env's device. Inside a process group `env` is this rank's share of
    the job's envs; with several ranks it must divide into
    num_mini_batches minibatches of envs."""

    def __init__(self, env, cfg: ppo_lib.PPOConfig, num_steps_per_env=24,
                 seed: int = 1, rnn_hidden_size: int = 64, log_dir=None):
        if dist.world_size() > 1 and env.num_envs % cfg.num_mini_batches:
            raise ValueError(
                f"this rank's {env.num_envs} envs must divide into "
                f"num_mini_batches={cfg.num_mini_batches}: the minibatch "
                "split happens per rank, and truncation would drop another "
                "env subset than the single-process path")
        self.is_main = dist.is_main()
        self.log_dir = log_dir
        self._log_f = None
        if log_dir is not None and self.is_main:
            os.makedirs(log_dir, exist_ok=True)
            self._log_f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.env = env
        self.device = dev = env.device
        with torch.random.fork_rng():   # weights from `seed` alone
            torch.manual_seed(seed)
            self.model = ActorCriticRecurrent(
                num_obs=env.num_obs, num_actions=env.num_actions,
                rnn_hidden_size=rnn_hidden_size,
                actor_hidden_dims=(64,), critic_hidden_dims=(64,)).to(dev)
        # the same weights on every rank (nothing to do outside a group)
        mesh.replicate(mesh.state_tensors(self.model))
        self.ppo_state = ppo_lib.PPOState(cfg, self.model)
        self.alg = RecurrentPPO(env, self.model, cfg, num_steps_per_env)
        # three random streams from the seed (and the rank): the env's
        # draws, the action noise, the minibatch permutations
        env_gen, self.noise_gen, self.perm_gen = rank_generators(
            dev, seed, dist.rank())
        self.env_state, self.obs = env.reset(env_gen)
        self.carry = self.model.initial_state(env.num_envs)
        self.last_dones = torch.zeros((env.num_envs,), dtype=torch.bool,
                                      device=dev)
        self.last_collection_time = 0.0
        self.last_learn_time = 0.0

    def _sync(self):
        if device_lib.on_card(self.device):
            spans.count("host_sync")
            torch.cuda.synchronize(self.device)

    def learn(self, num_iterations: int, log=print, log_every: int = 10,
              save_interval: int = 500):
        """Returns the mean step reward of every iteration."""
        history = []
        for it in range(num_iterations):
            if self.log_dir and self.is_main and it > 0 \
                    and it % save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{it}"))
            spans.begin_iteration(it)
            h0 = self.carry
            with spans.span("runner.collect") as collect:
                (self.env_state, self.obs, self.carry, self.last_dones, traj,
                 last_values, ep_stats, nres) = self.alg.collect(
                    self.env_state, self.obs, self.carry, self.last_dones,
                    self.noise_gen)
                self._sync()
            with spans.span("runner.learn") as learn:
                metrics = self.alg.update(self.ppo_state, traj, h0,
                                          last_values, self.perm_gen)
                self._sync()
            self.last_collection_time = collect.seconds
            self.last_learn_time = learn.seconds
            # the job's mean step reward (every rank holds as many envs)
            step_rew = traj.rewards.mean().reshape(1)
            dist.all_reduce_mean([step_rew])   # nothing outside a group
            history.append(step_rew[0])
            if it % log_every == 0:
                self._log(it, step_rew, nres, ep_stats, metrics, log)
            spans.end_iteration()
        if self.log_dir and self.is_main:
            self.save(os.path.join(self.log_dir, f"model_{num_iterations}"))
        return [float(h) for h in history]

    def _log(self, it, step_rew, nres, ep_stats, metrics, log):
        # ONE host transfer for the logged scalars, the job's sums;
        # episode-based metrics on the feedforward family's names so
        # the LSTM curve is directly comparable to flat_go1's
        # (on_policy_runner.py:140-154 deque semantics)
        sums = torch.stack([nres.to(torch.float32),
                            ep_stats["reward_sum"], ep_stats["len_sum"]])
        dist.all_reduce_sum([sums])
        device_lib.host_sync(sums)
        mean_rew, nres, rew_sum, len_sum, v_loss, s_loss = torch.cat([
            step_rew, sums, torch.stack([metrics["value_loss"],
                                         metrics["surrogate_loss"]])
        ]).tolist()
        n = max(int(nres), 1)
        if log and self.is_main:
            log(f"recurrent it {it} ep rew {rew_sum / n:.3f} "
                f"ep len {len_sum / n:.1f} step rew {mean_rew:.4f} "
                f"vloss {v_loss:.4f}")
        if self._log_f:
            self._log_f.write(json.dumps({
                "it": it, "Train/mean_step_reward": mean_rew,
                "Train/mean_reward": rew_sum / n,
                "Train/mean_episode_length": len_sum / n,
                "Train/dones": int(nres),
                "Loss/value_loss": v_loss,
                "Loss/surrogate_loss": s_loss,
            }) + "\n")
            self._log_f.flush()

    def close(self):
        """Close metrics.jsonl; the runner logs nothing afterwards."""
        if self._log_f:
            self._log_f.close()
            self._log_f = None

    # train-CLI protocol compatibility (no curricula yet)
    def force_terminal_schedules(self):
        pass

    def save(self, path):
        """One torch.save file of state dicts: the model, the optimizer,
        the learning rate and the update counter."""
        torch.save(self.ppo_state.state_dict(), os.path.abspath(path))

    def load(self, path, load_optimizer=True):
        ckpt = torch.load(os.path.abspath(path), map_location=self.device,
                          weights_only=True)
        self.ppo_state.load_state_dict(ckpt, load_optimizer=load_optimizer)

    def get_inference_policy(self, stochastic: bool = False):
        """Stateful deterministic policy: obs -> actions, the recurrent
        carry kept inside the closure (the reference's PolicyExporterLSTM
        semantics, helpers.py:201-226)."""
        model = self.model
        state = {"carry": model.initial_state(self.env.num_envs)}

        @torch.no_grad()
        def policy(obs):
            state["carry"], mean, _ = model.step(state["carry"], obs)
            return mean

        return policy
