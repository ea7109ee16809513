"""Dual-advantage PPO with Regularized Online Adaptation on torch tensors.

Counterpart of dwbc_tpu/rl/ppo.py:
  * 2-dim (leg, arm) rewards/values/advantages throughout;
  * advantage mixing with the ramped kappa schedule;
  * clipped surrogate over per-head ratios + clipped value loss;
  * Regularized Online Adaptation: L2(priv_latent - sg(hist_latent)) with
    the 4-number coef schedule;
  * DAgger-style history-encoder regression phase with its own Adam;
  * optional arm torque supervision against the OSC expert through the
    analytic PD forward model, weight annealed to 0;
  * KL-adaptive learning rate option;
  * min-std floor after each update.

The JAX package keeps its state in an immutable `PPOState` pytree and
returns a new one per update; here `PPOState` owns the model and both
optimizers (its constructor does what the JAX `init_state` and
`make_optimizers` do) and `update` / `update_dagger` change it in place.

Data parallelism (the JAX package's `axis_name` path under shard_map):
inside a process group (`parallel.distributed.active()`) every rank
holds a replica of the parameters and its own share of the envs. Each rank shuffles and
minibatches its local rows; after each minibatch's backward pass the
gradients and the loss statistics (the KL among them) are averaged over
the ranks in one all-reduce, so the adaptive learning rate, the clip and
the Adam step are the same on every rank and the replicas stay equal.
`compute_gae` then normalises the advantages with the global mean and
population std. With DWBC_BF16_OBS=1 in the environment at import,
`update` stores the permuted observation batch as bfloat16 and casts
each minibatch back to float32 where it is read, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import actor_critic as ac_lib
from ..parallel import distributed as dist
from ..utils import device as device_lib
from ..utils import spans

# see update(): bf16 storage of the permuted observations
_BF16_OBS = os.environ.get("DWBC_BF16_OBS") == "1"


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Leaf values from WidowGo1RoughCfgPPO.algorithm
    (widowGo1_config.py:343-366), fresh-training schedules."""

    clip_param: float = 0.2
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    value_loss_coef: float = 1.0
    entropy_coef: float = 0.0
    learning_rate: float = 2e-4
    schedule: str = "fixed"  # 'fixed' | 'adaptive'
    desired_kl: Optional[float] = None
    gamma: float = 0.99
    lam: float = 0.95
    max_grad_norm: float = 1.0
    min_policy_std: Tuple[float, ...] = tuple(
        [0.15, 0.25, 0.25] * 4 + [0.2] * 3 + [0.05] * 3)
    mixing_schedule: Tuple[float, float, float] = (1.0, 0.0, 3000.0)
    torque_supervision: bool = False
    torque_supervision_schedule: Tuple[float, float, float] = (0.0, 1000.0, 1000.0)
    adaptive_arm_gains: bool = False
    dagger_update_freq: int = 20
    priv_reg_coef_schedule: Tuple[float, float, float, float] = (0.0, 0.1, 3000.0, 7000.0)
    num_leg_actions: int = 12
    num_heads: int = 2      # 2 = dual leg/arm (widowGo1); 1 = plain PPO
    use_dagger: bool = True
    use_roa: bool = True    # Regularized Online Adaptation losses


class Transition(NamedTuple):
    """One rollout step, stacked to (T, N, ...) by the rollout."""

    obs: torch.Tensor               # (..., num_obs)
    actions: torch.Tensor           # (..., 18)
    rewards: torch.Tensor           # (..., 2) [leg, arm]
    dones: torch.Tensor             # (...,) bool
    time_outs: torch.Tensor         # (...,) bool
    values: torch.Tensor            # (..., 2)
    log_probs: torch.Tensor         # (..., 2)
    mu: torch.Tensor                # (..., 18)
    sigma: torch.Tensor             # (..., 18)
    target_arm_torques: torch.Tensor   # (..., 6) zeros if unused
    current_arm_dof_pos: torch.Tensor  # (..., 6)
    current_arm_dof_vel: torch.Tensor  # (..., 6)


class PPOState:
    """The model, its optimizers, the (possibly KL-adapted) learning
    rate and the count of update iterations completed.

    `opt` is Adam over every parameter; its learning rate is set from
    `learning_rate` at each minibatch step. `hist_opt` is a second Adam
    over the history encoder alone (the DAgger phase trains only the
    adaptation module) at the fixed `cfg.learning_rate`; a model without
    a history encoder (the single-head family) has none, and `hist_opt`
    is None. Every parameter
    always holds a gradient tensor (zeros where a loss does not reach it),
    so that Adam's step count advances for all of them together, as the
    single count of the JAX package's optimizer does."""

    def __init__(self, cfg: PPOConfig, model: torch.nn.Module):
        self.model = model
        self.params = list(model.parameters())
        encoder = getattr(getattr(model, "actor", None), "history_encoder",
                          None)
        self.hist_params = [] if encoder is None else list(
            encoder.parameters())
        adam = dict(lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        self.opt = torch.optim.Adam(self.params, **adam)
        self.hist_opt = (torch.optim.Adam(self.hist_params, **adam)
                         if self.hist_params else None)
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.learning_rate = float(np.float32(cfg.learning_rate))
        self.counter = 0

    def state_dict(self):
        hist = None if self.hist_opt is None else self.hist_opt.state_dict()
        return dict(model=self.model.state_dict(), opt=self.opt.state_dict(),
                    hist_opt=hist, learning_rate=self.learning_rate, counter=self.counter)

    def load_state_dict(self, d, load_optimizer: bool = True):
        self.model.load_state_dict(d["model"])
        if load_optimizer:
            self.opt.load_state_dict(d["opt"])
            if self.hist_opt is not None:
                self.hist_opt.load_state_dict(d["hist_opt"])
        self.learning_rate = float(d["learning_rate"])
        self.counter = int(d["counter"])


# ---------------------------------------------------------------------------
# schedules (ppo.py:301-305, :178-179), in float32 like the JAX package


def _ramp(counter, start, length) -> np.float32:
    f32 = np.float32
    return np.clip((f32(counter) - f32(start)) / f32(length), f32(0.0),
                   f32(1.0))


def mixing_ratio(cfg: PPOConfig, counter) -> float:
    s = cfg.mixing_schedule
    return float(_ramp(counter, s[1], s[2]) * np.float32(s[0]))


def torque_supervision_weight(cfg: PPOConfig, counter) -> float:
    s = cfg.torque_supervision_schedule
    return float((np.float32(1.0) - _ramp(counter, s[1], s[2]))
                 * np.float32(s[0]))


def priv_reg_coef(cfg: PPOConfig, counter) -> float:
    s = cfg.priv_reg_coef_schedule
    return float(_ramp(counter, s[2], s[3]) * np.float32(s[1] - s[0])
                 + np.float32(s[0]))


def logp_heads(cfg: PPOConfig, actions, mean, std):
    if cfg.num_heads == 1:
        lp = (-0.5 * torch.square((actions - mean) / std) - torch.log(std)
              - 0.5 * math.log(2 * math.pi))
        return lp.sum(-1, keepdim=True)
    return ac_lib.log_prob_per_head(actions, mean, std, cfg.num_leg_actions)


def entropy_heads(cfg: PPOConfig, std, batch_shape):
    if cfg.num_heads == 1:
        ent = (0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std)).sum(
            -1, keepdim=True)
        return ent.expand(tuple(batch_shape) + (1,))
    return ac_lib.entropy_per_head(std, batch_shape, cfg.num_leg_actions)


# ---------------------------------------------------------------------------
# GAE (rollout_storage.py:136-150): reverse loop over T on (N, 2) tensors


def compute_gae(cfg: PPOConfig, traj: Transition, last_values: torch.Tensor):
    """Returns (returns, advantages) with global advantage normalization.
    Inside a process group the mean and std are the whole job's (every rank
    holds the same number of rows): the all-reduced sum gives the mean,
    then the all-reduced squared deviations give the std.

    Timeout bootstrap mirrors ppo.py:133-134: rewards += gamma * values *
    time_out before GAE."""
    with spans.span("ppo.gae"):
        return _gae(cfg, traj, last_values)


def _gae(cfg: PPOConfig, traj: Transition, last_values: torch.Tensor):
    rewards = traj.rewards + cfg.gamma * traj.values * traj.time_outs[..., None]
    not_done = 1.0 - traj.dones[..., None].to(torch.float32)
    advantage = torch.zeros_like(last_values)
    next_values = last_values
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + not_done[t] * cfg.gamma * next_values - traj.values[t]
        advantage = delta + not_done[t] * cfg.gamma * cfg.lam * advantage
        next_values = traj.values[t]
        advs[t] = advantage
    advs = torch.stack(advs)
    returns = advs + traj.values
    # the population std (correction=0), one mean and one std over the
    # whole (T, N, 2) block
    if not dist.active():
        advantages = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        return returns, advantages
    count = advs.numel() * dist.world_size()
    mean = dist.all_reduce_sum([advs.sum().reshape(1)])[0] / count
    centred = advs - mean
    var = dist.all_reduce_sum([torch.square(centred).sum().reshape(1)])[0] \
        / count
    return returns, centred / (torch.sqrt(var) + 1e-8)


# ---------------------------------------------------------------------------
# optimizer steps


def _clip_by_global_norm(grads, max_norm: float):
    """g * max_norm / norm when norm >= max_norm, else g unchanged (no
    epsilon under the norm), in place and without a host round trip."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


def _adam_step(opt: torch.optim.Adam, params, max_norm: float, lr: float):
    _clip_by_global_norm([p.grad for p in params], max_norm)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def adapt_learning_rate(cfg: PPOConfig, lr: float, kl: float) -> float:
    """The adaptive-KL learning-rate rule (ppo.py:189-195) in float32, as
    the JAX package computes it: its compiled update divides by 1.5 as a
    multiplication by float32(1 / 1.5), one ulp off the true quotient for
    a third of all rates, so the same product is taken here and the two
    packages' rates stay bit-equal."""
    f32 = np.float32
    kl = f32(kl)
    if kl > f32(cfg.desired_kl * 2.0):
        lr = float(max(f32(1e-5), f32(lr) * f32(1.0 / 1.5)))
    if f32(cfg.desired_kl / 2.0) > kl > 0.0:
        lr = float(min(f32(1e-2), f32(lr) * f32(1.5)))
    return lr


def _mean_over_ranks(params, stats):
    """Average every parameter's gradient and the scalar `stats` over the
    ranks in one all-reduce; returns the averaged stats (detached)."""
    names = list(stats)
    vec = torch.stack([stats[k].detach() for k in names])
    dist.all_reduce_mean([p.grad for p in params] + [vec])
    return dict(zip(names, vec.unbind()))


def _permutation(B: int, gen, perm, device):
    if perm is not None:
        return torch.as_tensor(perm, dtype=torch.long, device=device)
    return torch.randperm(B, generator=gen, device=device)


# ---------------------------------------------------------------------------
# PPO update


def update(cfg: PPOConfig, state: PPOState, traj: Transition,
           returns: torch.Tensor, advantages: torch.Tensor,
           gen: Optional[torch.Generator] = None,
           arm_default: Optional[Tuple[torch.Tensor, ...]] = None,
           perm: Optional[torch.Tensor] = None):
    """One full PPO update: num_learning_epochs x num_mini_batches
    minibatch gradient steps over the flattened (T*N) batch. The
    minibatch permutation comes from `gen` (a torch.Generator on the
    batch's device) unless `perm` gives it. Inside a process group the
    batch is this rank's share and the gradients and statistics are averaged
    over the ranks (module docstring). Changes `state` in place and
    returns the metrics (device scalars and schedule values)."""
    model = state.model
    T, N = traj.dones.shape
    B = T * N
    nmb = cfg.num_mini_batches
    mb_size = B // nmb
    dev = traj.obs.device
    # Permute the batch ONCE, then minibatches are contiguous slices: one
    # permutation serves every epoch, so a gather per minibatch step would
    # move num_learning_epochs times the batch for nothing. Rows past
    # mb_size * nmb are never used.
    used = _permutation(B, gen, perm, dev)[:mb_size * nmb]

    def flat(x):
        return x.reshape((B,) + x.shape[2:])[used]

    f = {k: flat(v) for k, v in traj._asdict().items()
         if k in ("obs", "actions", "log_probs", "values", "mu", "sigma")}
    if _BF16_OBS:
        # every minibatch step re-reads the permuted observations; stored
        # bf16 they move half the bytes. Only the stored values are
        # rounded: the networks compute in float32 (cast on read).
        f["obs"] = f["obs"].to(torch.bfloat16)
    f_returns = flat(returns)
    f_adv = flat(advantages)
    mix = mixing_ratio(cfg, state.counter)
    reg_coef = priv_reg_coef(cfg, state.counter)
    ts_weight = torque_supervision_weight(cfg, state.counter)
    torque_branch = cfg.torque_supervision and arm_default is not None
    if torque_branch:
        f_tau = flat(traj.target_arm_torques)
        f_pos = flat(traj.current_arm_dof_pos)
        f_vel = flat(traj.current_arm_dof_vel)
    adaptive_lr = cfg.desired_kl is not None and cfg.schedule == "adaptive"

    def loss_fn(sl):
        obs = f["obs"][sl].float()
        mean = model.act_mean(obs, False)
        std = model.std
        logp = logp_heads(cfg, f["actions"][sl], mean, std)
        value = model.evaluate(obs)
        entropy = entropy_heads(cfg, std, (obs.shape[0],))

        if cfg.use_roa:
            # ROA regularizer (ppo.py:173-180)
            diff = model.priv_latent(obs) - model.hist_latent(obs).detach()
            # safe norm: the gradient of ||x|| at x = 0 is NaN otherwise
            priv_reg_loss = torch.sqrt(
                torch.sum(torch.square(diff), -1) + 1e-12).mean()
        else:
            priv_reg_loss = torch.zeros((), device=dev)

        # advantage mixing (ppo.py:199-201)
        adv = f_adv[sl]
        if cfg.num_heads == 2:
            mixed = torch.stack([adv[:, 0] + mix * adv[:, 1],
                                 adv[:, 1] + mix * adv[:, 0]], -1)
        else:
            mixed = adv

        ratio = torch.exp(logp - f["log_probs"][sl])
        surr = -mixed * ratio
        surr_clipped = -mixed * torch.clamp(ratio, 1 - cfg.clip_param,
                                            1 + cfg.clip_param)
        surrogate_loss = torch.maximum(surr, surr_clipped).mean()

        old_values, ret = f["values"][sl], f_returns[sl]
        v_clipped = old_values + torch.clamp(value - old_values,
                                             -cfg.clip_param, cfg.clip_param)
        v_loss = torch.maximum(torch.square(value - ret),
                               torch.square(v_clipped - ret)).mean()

        loss = (surrogate_loss + cfg.value_loss_coef * v_loss
                - cfg.entropy_coef * entropy.mean()
                + reg_coef * priv_reg_loss)
        aux = dict(value_loss=v_loss, surrogate_loss=surrogate_loss,
                   priv_reg_loss=priv_reg_loss,
                   arm_torques_loss=torch.zeros((), device=dev))

        if torque_branch:
            # analytic PD forward model of the env's arm torque path
            # (ppo.py:304-324 arm_fk_{fixed,adaptive}_gains)
            p_g, d_g, def_pos, a_scale = arm_default
            # Transitions captured on a blow-up-guard step can carry
            # non-finite or ballistic arm state and OSC targets, which
            # would poison the WHOLE loss even at ts_weight = 0 (NaN * 0 =
            # NaN, and inf entering the sqrt-gain backward). All three are
            # rollout DATA (no grad path), so element-wise masking at
            # source is exact: bad elements contribute 0 to both the loss
            # and the gradient.
            raw_tgt, raw_pos, raw_vel = f_tau[sl], f_pos[sl], f_vel[sl]
            # |target| < 100 Nm: the widow arm's effort limits are ~20 Nm,
            # larger OSC outputs only occur for tumbling/exploding states
            # where the expert itself is meaningless
            ok = (torch.isfinite(raw_tgt) & (torch.abs(raw_tgt) < 100.0)
                  & torch.isfinite(raw_pos) & (torch.abs(raw_pos) < 1e3)
                  & torch.isfinite(raw_vel) & (torch.abs(raw_vel) < 50.0))
            tgt = torch.where(ok, raw_tgt, 0.0)
            arm_pos = torch.where(ok, raw_pos, 0.0)
            arm_vel = torch.where(ok, raw_vel, 0.0)
            if cfg.adaptive_arm_gains:
                target_pos = mean[:, 12:-6]
                delta_p = mean[:, -6:]
                # floor at 1e-6, not 0: d/dx sqrt(x) -> inf at the 0-clamp
                # and inf * ts_weight(= 0) = NaN — one env whose policy
                # pushed a gain to the floor would poison every gradient
                pg = torch.clamp(p_g + delta_p, min=1e-6)
                dg = 2.0 * torch.sqrt(pg)
            else:
                target_pos = mean[:, -6:]
                pg, dg = p_g, d_g
            arm_tau = (pg * (target_pos * a_scale + def_pos - arm_pos)
                       - dg * arm_vel)
            err = torch.where(ok, arm_tau - tgt, 0.0)
            denom = torch.clamp(torch.sum(ok), min=1)
            ts_loss = torch.sum(torch.square(err)) / denom
            loss = loss + ts_loss * ts_weight
            aux["arm_torques_loss"] = ts_loss

        # KL for the adaptive learning rate (ppo.py:183-187): a statistic,
        # not part of the loss
        with torch.no_grad():
            old_mu, old_sigma = f["mu"][sl], f["sigma"][sl]
            kl = torch.sum(
                torch.log(std / old_sigma + 1e-5)
                + (torch.square(old_sigma) + torch.square(old_mu - mean))
                / (2.0 * torch.square(std)) - 0.5, dim=-1)
            aux["kl_mean"] = kl.mean()
        return loss, aux

    keys = ("value_loss", "surrogate_loss", "priv_reg_loss",
            "arm_torques_loss")
    totals = {k: torch.zeros((), device=dev) for k in keys}
    lr = state.learning_rate
    # the same permutation is reused every epoch, like the reference's
    # single randperm (rollout_storage.py:163)
    for _ in range(cfg.num_learning_epochs):
        for i in range(nmb):
            with spans.span("ppo.minibatch"):
                state.opt.zero_grad(set_to_none=False)
                loss, aux = loss_fn(slice(i * mb_size, (i + 1) * mb_size))
                loss.backward()
                if dist.active():
                    aux = _mean_over_ranks(state.params, aux)
                if adaptive_lr:
                    # changed before the step of the same minibatch.
                    # Reading the KL is one host round trip per
                    # minibatch, on this schedule only.
                    device_lib.host_sync(aux["kl_mean"])
                    lr = adapt_learning_rate(cfg, lr, aux["kl_mean"].item())
                _adam_step(state.opt, state.params, cfg.max_grad_norm, lr)
                for k in keys:
                    totals[k] = totals[k] + aux[k].detach()

    enforce_min_std(cfg, model)   # min-std floor (ppo.py:293-296)

    n_updates = cfg.num_learning_epochs * nmb
    metrics = {k: v / n_updates for k, v in totals.items()}
    metrics["mixing_ratio"] = mix
    metrics["priv_reg_coef"] = reg_coef
    metrics["torque_supervision_weight"] = ts_weight
    metrics["hist_latent_loss"] = 0.0
    # per-head advantage diagnostics: is the leg head's gradient signal
    # drowned by the kappa-mixed arm advantage?
    if cfg.num_heads == 2:
        adv_abs = torch.abs(advantages).mean((0, 1))  # all B rows
        dist.all_reduce_mean([adv_abs])   # nothing outside a group
        leg_abs, arm_abs = adv_abs
        metrics["adv_leg_abs"] = leg_abs
        metrics["adv_arm_abs"] = arm_abs
        metrics["adv_leg_mixed_share"] = leg_abs / (
            leg_abs + mix * arm_abs + 1e-8)
    state.learning_rate = lr
    state.counter += 1
    return metrics


def update_dagger(cfg: PPOConfig, state: PPOState, traj: Transition,
                  gen: Optional[torch.Generator] = None,
                  perm: Optional[torch.Tensor] = None):
    """DAgger phase: regress hist latent <- sg(priv latent), training only
    the history encoder (ppo.py:265-291) with `state.hist_opt` at the
    fixed cfg.learning_rate. Every other parameter comes out bit-equal.
    Inside a process group the loss and gradients are averaged over the
    ranks per minibatch."""
    if state.hist_opt is None:
        raise ValueError("update_dagger needs a model with a history "
                         "encoder")
    model = state.model
    T, N = traj.dones.shape
    B = T * N
    nmb = cfg.num_mini_batches
    mb_size = B // nmb
    dev = traj.obs.device
    used = _permutation(B, gen, perm, dev)[:mb_size * nmb]
    flat_obs = traj.obs.reshape(B, -1)[used]   # one gather (see update)

    total = torch.zeros((), device=dev)
    for _ in range(cfg.num_learning_epochs):
        for i in range(nmb):
            with spans.span("ppo.dagger_minibatch"):
                obs = flat_obs[i * mb_size:(i + 1) * mb_size]
                priv = model.priv_latent(obs).detach()
                hist = model.hist_latent(obs)
                loss = torch.sqrt(
                    torch.sum(torch.square(priv - hist), -1) + 1e-12).mean()
                # the gradient outside the history encoder is zero (the
                # privileged latent is detached), so the global-norm clip
                # over the history encoder's gradients is the clip over
                # all of them
                grads = torch.autograd.grad(loss, state.hist_params)
                for p, g in zip(state.hist_params, grads):
                    p.grad = g
                if dist.active():
                    loss = _mean_over_ranks(state.hist_params,
                                            {"loss": loss})["loss"]
                _adam_step(state.hist_opt, state.hist_params,
                           cfg.max_grad_norm, cfg.learning_rate)
                total = total + loss.detach()
    n_updates = cfg.num_learning_epochs * nmb
    state.counter += 1
    return {"hist_latent_loss": total / n_updates}


@torch.no_grad()
def enforce_min_std(cfg: PPOConfig, model: torch.nn.Module):
    """Clamp the std parameter in place at the per-joint floor; a floor of
    another shape means no per-joint floor for this task family."""
    device_lib.host_sync(model.std)
    floor = torch.tensor(cfg.min_policy_std, dtype=torch.float32,
                         device=model.std.device)
    if floor.shape != model.std.shape:
        return
    model.std.copy_(torch.maximum(model.std, floor))
