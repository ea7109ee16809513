"""On-policy training runner: the rollout, the learn step and the
iteration loop.

Counterpart of dwbc_tpu/rl/runner.py. The JAX package runs the 40-step
rollout as one compiled lax.scan and the update as a second compiled
program; here `Rollout.collect` is a Python loop over eager steps under
`torch.no_grad()` and `Rollout.learn_step` runs the PPO update (or the
DAgger phase every dagger_update_freq iterations) with autograd on the
on-device trajectory.

Emits the reference's metric names (Perf/total_fps, Perf/collection time,
Perf/learning_time, Loss/*, Policy/*_noise_std) for direct comparability.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import time
from typing import Optional

import torch

from ..envs.vec_env import VecEnv
from ..models import actor_critic as ac_lib
from . import ppo as ppo_lib


def init_at_random_ep_len(env_state, max_episode_length: int,
                          gen: torch.Generator):
    """Desynchronise the initial episode clocks so resets and timeouts
    spread over the rollout (init_at_random_ep_len=True, reference
    train.py:51, on_policy_runner.py:102-104)."""
    el = env_state.episode_length
    return dataclasses.replace(env_state, episode_length=torch.randint(
        0, int(max_episode_length), el.shape, generator=gen, device=el.device,
        dtype=torch.int32))


class Rollout:
    """Env + model + ppo cfg; `collect` runs one rollout of num_steps.
    The model is an ActorCritic, an MlpActorCritic or any module with
    their surface (act_mean / evaluate / priv_latent / hist_latent /
    std)."""

    def __init__(self, env, model: torch.nn.Module, cfg: ppo_lib.PPOConfig,
                 num_steps: int = 40):
        if not isinstance(env, VecEnv):
            raise TypeError("env must satisfy the VecEnv protocol "
                            "(envs/vec_env.py)")
        self.env = env
        self.model = model
        self.cfg = cfg
        self.num_steps = num_steps
        # arm PD constants for the torque-supervision forward model
        # (on_policy_runner.py:91)
        if cfg.num_heads == 2:
            self.arm_default = (env.p_gains[12:18], env.d_gains[12:18],
                                env.default_dof_pos[12:18],
                                env.action_scale[12:18])
        else:
            self.arm_default = None
        # whether env.step takes the curriculum counter argument
        self.has_counter = "counter" in inspect.signature(
            type(env).step).parameters

    def stat_keys(self):
        env = self.env
        arm_names = getattr(env, "arm_reward_names", [])
        keys = (["rew_" + k for k in list(env.reward_names) + list(arm_names)]
                + ["metric_" + k for k in getattr(env, "metric_names", [])])
        if not hasattr(env, "arm_reward_names"):
            keys.append("terrain_level")
        else:
            keys += ["term_roll", "term_pitch", "term_z", "term_timeout",
                     "term_bad", "step_base_height_rel", "step_z_margin_low",
                     "step_vel_x", "step_cmd_x"]
        return keys + ["reward_sum", "arm_reward_sum", "len_sum"]

    @torch.no_grad()
    def collect(self, env_state, obs, counter: float, gen: torch.Generator,
                hist_encoding: bool):
        """num_steps of (act -> env.step). Returns (env_state, obs,
        traj, stats, nres): traj a Transition of (T, N, ...) tensors,
        stats the per-key sums of the env's episode statistics, nres the
        number of resets. `gen` draws the action noise."""
        env = self.env
        model = self.model
        N = env.num_envs
        dev = obs.device
        std = model.std
        stats = {k: torch.zeros((), device=dev) for k in self.stat_keys()}
        nres = torch.zeros((), dtype=torch.int64, device=dev)
        steps = []
        no_arm = torch.zeros((N, 6), device=dev)
        for _ in range(self.num_steps):
            mean = model.act_mean(obs, hist_encoding)
            actions = ac_lib.normal_sample(gen, mean, std)
            logp = ppo_lib.logp_heads(self.cfg, actions, mean, std)
            values = model.evaluate(obs)
            if self.has_counter:
                env_state, out = env.step(env_state, actions, counter)
            else:
                env_state, out = env.step(env_state, actions)
            if self.cfg.num_heads == 2:
                rewards = torch.stack([out.rew, out.arm_rew], -1)
            else:
                rewards = out.rew[..., None]
            # the OSC supervision data, zeros where the env sends none
            # (a single-reward env's step output has no extras at all)
            extras = getattr(out, "extras", {})
            arm = [extras.get(k, no_arm)
                   for k in ("target_arm_torques", "current_arm_dof_pos",
                             "current_arm_dof_vel")]
            steps.append((obs, actions, rewards, out.reset, out.time_outs,
                          values, logp, mean, *arm))
            for k, v in out.episode_stats.items():
                stats[k] = stats[k] + v
            nres = nres + out.num_resets
            obs = out.obs
        cols = [torch.stack(c) for c in zip(*steps)]
        traj = ppo_lib.Transition(
            *cols[:8], std.expand_as(cols[7]).clone(), *cols[8:])
        return env_state, obs, traj, stats, nres

    def learn_step(self, ppo_state: ppo_lib.PPOState, traj, last_obs,
                   gen: torch.Generator, dagger: bool):
        """The DAgger phase, or GAE + the PPO update, on one trajectory;
        changes `ppo_state` in place and returns the metrics. `gen` draws
        the minibatch permutation."""
        if dagger:
            return ppo_lib.update_dagger(self.cfg, ppo_state, traj, gen)
        with torch.no_grad():
            last_values = self.model.evaluate(last_obs)
            returns, advantages = ppo_lib.compute_gae(self.cfg, traj,
                                                      last_values)
        return ppo_lib.update(self.cfg, ppo_state, traj, returns, advantages,
                              gen, arm_default=self.arm_default)


def _make_writers(log_dir: str, run_config=None):
    """Optional metric sinks matching the reference's wandb + TensorBoard
    pair (on_policy_runner.py:36, :43, :106, :208-231). Both are gated on
    availability/config so headless hosts run without them; the always-on
    sink is metrics.jsonl. `run_config` (env cfg + ppo cfg as a dict) is
    uploaded to wandb like the reference's config-source upload
    (train.py:42-47)."""
    writers = []
    try:  # TensorBoard; absent in minimal images
        from torch.utils.tensorboard import SummaryWriter

        tb = SummaryWriter(log_dir=log_dir, flush_secs=10)
        writers.append(lambda it, d: [tb.add_scalar(k, v, it)
                                      for k, v in d.items()
                                      if isinstance(v, (int, float))])
    except ImportError:
        pass
    if os.environ.get("WANDB_PROJECT"):
        try:  # opt-in wandb (reference train.py:42-47)
            import wandb

            if wandb.run is None:
                wandb.init(project=os.environ["WANDB_PROJECT"],
                           dir=log_dir, config=run_config or {})
            writers.append(lambda it, d: wandb.log(d, step=it))
        except ImportError:
            pass
    return writers


def rank_generators(device, seed: int):
    """Three random streams from `seed`: the env's draws, the action
    noise, the minibatch permutations (rank 0's of the program's)."""
    base = 3 * seed
    return [torch.Generator(device=device).manual_seed(base + i)
            for i in range(3)]


class OnPolicyRunner:
    """The host side of training: iteration loop, logging, checkpoints.
    Runs on the env's device."""

    def __init__(self, env, cfg: ppo_lib.PPOConfig = ppo_lib.PPOConfig(),
                 num_steps_per_env: int = 40, log_dir: Optional[str] = None,
                 seed: int = 1, save_interval: int = 500, model=None):
        self.env = env
        self.cfg = cfg
        self.device = dev = env.device
        self.is_main = True
        self.num_envs_global = env.num_envs
        self.log_dir = log_dir
        self.save_interval = save_interval
        if model is not None:
            self.model = model.to(dev)
        elif cfg.num_heads == 2:
            adaptive = bool(env.cfg.control.adaptive_arm_gains)
            init_std = tuple([0.8, 1.0, 1.0] * 4 + [1.0] * 6)
            if adaptive:
                init_std = init_std + (1.0,) * 6
            with torch.random.fork_rng():   # weights from `seed` alone
                torch.manual_seed(seed)
                self.model = ac_lib.ActorCritic(
                    num_prop=env.num_proprio, num_priv=env.num_priv,
                    num_hist=env.cfg.env.history_len,
                    adaptive_arm_gains=adaptive, init_std=init_std).to(dev)
        else:
            from ..models.mlp_actor_critic import MlpActorCritic
            with torch.random.fork_rng():
                torch.manual_seed(seed)
                self.model = MlpActorCritic(
                    num_obs=env.num_obs, num_actions=env.num_actions).to(dev)
        self.ppo_state = ppo_lib.PPOState(cfg, self.model)
        self.rollout = Rollout(env, self.model, cfg, num_steps_per_env)
        # three random streams from the seed: the env's
        # draws, the action noise, the minibatch permutations
        env_gen, self.noise_gen, self.perm_gen = rank_generators(
            dev, seed)
        self.env_state, self.obs = env.reset(env_gen)
        self.env_state = init_at_random_ep_len(
            self.env_state, env.max_episode_length, env_gen)
        self.it = 0
        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.last_collection_time = 0.0
        self.last_learn_time = 0.0
        self.last_traj = None   # the newest trajectory, for inspection
        if self.log_dir and self.is_main:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_f = open(os.path.join(self.log_dir, "metrics.jsonl"),
                               "a")
            run_config = {
                "env_cfg": dataclasses.asdict(env.cfg),
                "ppo_cfg": dataclasses.asdict(cfg),
                "num_envs": self.num_envs_global,
                "num_steps_per_env": num_steps_per_env,
            }
            self._writers = _make_writers(self.log_dir, run_config)
        else:
            self._log_f = None
            self._writers = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def learn(self, num_iterations: int, log_every: int = 10):
        env = self.env
        for it in range(self.it, self.it + num_iterations):
            counter = float(it + 1)  # curriculum tick
            dagger = (self.cfg.use_dagger
                      and (it % self.cfg.dagger_update_freq) == 0)

            self.last_traj = None   # free it before the next one is built
            t0 = time.time()
            (self.env_state, self.obs, traj, stats, nres) = self.rollout.collect(
                self.env_state, self.obs, counter, self.noise_gen,
                hist_encoding=dagger)
            self._sync()
            collection_time = time.time() - t0

            t0 = time.time()
            metrics = self.rollout.learn_step(self.ppo_state, traj, self.obs,
                                              self.perm_gen, dagger)
            self._sync()
            learn_time = time.time() - t0

            self.tot_timesteps += self.rollout.num_steps * self.num_envs_global
            self.tot_time += collection_time + learn_time
            self.last_collection_time = collection_time
            self.last_learn_time = learn_time
            self.last_traj = traj
            self.it = it + 1

            if it % log_every == 0 or it == num_iterations - 1:
                self._log(it, metrics, stats, nres, collection_time, learn_time)
            if (self.log_dir and self.is_main and it > 0
                    and it % self.save_interval == 0):
                self.save(os.path.join(self.log_dir, f"model_{it}"))
        if self.log_dir and self.is_main:
            self.save(os.path.join(self.log_dir, f"model_{self.it}"))

    def _log(self, it, metrics, stats, nres, collection_time, learn_time):
        fps = int(self.rollout.num_steps * self.num_envs_global
                  / max(collection_time + learn_time, 1e-9))
        # ONE host transfer for the ~75 logged scalars: a .item() each
        # would be as many synchronisations
        scalars = {"m/" + k: v for k, v in metrics.items()}
        scalars.update({"s/" + k: v for k, v in stats.items()})
        scalars["nres"] = nres
        on_dev = [k for k, v in scalars.items() if torch.is_tensor(v)]
        vec = torch.stack([scalars[k].detach().to(torch.float32)
                           for k in on_dev])
        std = self.model.std.detach()
        host = torch.cat([vec, std]).tolist()
        scalars.update(zip(on_dev, host))
        std = host[len(on_dev):]
        metrics = {k: float(scalars["m/" + k]) for k in metrics}
        stats = {k: float(scalars["s/" + k]) for k in stats}
        nres = max(int(scalars["nres"]), 1)
        d = {
            "it": it,
            "Perf/total_fps": fps,
            "Perf/collection time": collection_time,
            "Perf/learning_time": learn_time,
            "Loss/learning_rate": float(self.ppo_state.learning_rate),
            "Policy/leg_mean_noise_std": sum(std[:12]) / 12,
            "Policy/arm_mean_noise_std": (sum(std[12:]) / len(std[12:])
                                          if len(std) > 12 else 0.0),
            "Train/mean_reward": stats["reward_sum"] / nres,
            "Train/mean_arm_reward": stats["arm_reward_sum"] / nres,
            "Train/mean_episode_length": stats["len_sum"] / nres,
            "Train/dones": (nres / self.num_envs_global
                            / self.rollout.num_steps),
        }
        for k, v in metrics.items():
            d["Loss/" + k] = v
        for k, v in stats.items():
            if k.startswith(("rew_", "metric_")):
                d["Episode/" + k] = v / nres
            elif k.startswith("term_"):
                # fraction of terminations with this cause (causes overlap)
                d["Episode/" + k] = v / nres
            elif k.startswith("step_"):
                # per-step per-env mean over the whole rollout
                d["Episode/" + k] = v / self.rollout.num_steps
        if "terrain_level" in stats:  # per-step mean, not per-reset
            d["Episode/terrain_level"] = (stats["terrain_level"]
                                          / self.rollout.num_steps)
        line = (f"it {it:5d} | fps {fps:8d} | rew {d['Train/mean_reward']:.3f}"
                f" | arm {d['Train/mean_arm_reward']:.3f}"
                f" | len {d['Train/mean_episode_length']:.1f}"
                f" | collect {collection_time:.3f}s learn {learn_time:.3f}s")
        if self.is_main:
            print(line, flush=True)
        if self._log_f:
            self._log_f.write(json.dumps(d) + "\n")
            self._log_f.flush()
        for w in self._writers:
            w(it, d)

    def close(self):
        """Close metrics.jsonl; the runner logs nothing afterwards."""
        if self._log_f:
            self._log_f.close()
            self._log_f = None

    # -- checkpoint ---------------------------------------------------

    def save(self, path: str):
        """One torch.save file of state dicts: the model, the optimizers,
        the learning rate, the schedule counter and the iteration."""
        ckpt = self.ppo_state.state_dict()
        ckpt["it"] = self.it
        torch.save(ckpt, os.path.abspath(path))

    def load(self, path: str, load_optimizer: bool = True):
        """Restore a checkpoint; with load_optimizer=False both optimizers
        keep their present state."""
        ckpt = torch.load(os.path.abspath(path), map_location=self.device,
                          weights_only=True)
        self.ppo_state.load_state_dict(ckpt, load_optimizer=load_optimizer)
        self.it = int(ckpt["it"])

    def force_terminal_schedules(self):
        """Reference RESUME=True semantics (widowGo1_config.py:35, :359,
        :366): jump every counter-driven schedule — env curricula (driven
        by the iteration counter) and PPO mixing/priv-reg/torque-
        supervision (driven by ppo_state.counter) — to terminal values."""
        big = 1_000_000
        self.it = max(self.it, big)
        self.ppo_state.counter = max(self.ppo_state.counter, big)

    def get_inference_policy(self, stochastic: bool = False):
        model = self.model

        @torch.no_grad()
        def policy(obs, gen: Optional[torch.Generator] = None):
            mean = model.act_mean(obs, True)
            if stochastic and gen is not None:
                return ac_lib.normal_sample(gen, mean, model.std)
            return mean

        return policy
