"""The port's multi-rank dry run (the counterpart of
__graft_entry__.dryrun_multichip): `python -m dwbc_tpu_torch.parallel.dryrun
2 --cpu` runs two gloo processes, each with 2 widowGo1 envs on the plane,
one rollout and one data-parallel PPO update, and checks that the
replicas end bitwise equal. The CLI's main() is called in this process;
it spawns the two ranks."""

from dwbc_tpu_torch.parallel import dryrun


def test_dryrun_two_gloo_ranks(capfd, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun.main(["2", "--cpu"])
    out = capfd.readouterr().out
    assert "dryrun(2 ranks, cpu): OK" in out, out
