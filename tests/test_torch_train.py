"""The port's training CLI on the CPU: a few rounds end to end (every
optimizer state, the pipelined scheduler, the chaos engine's fault flags,
checkpoint and resume), the other LLM families refused, and no silent
move to the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.launch import train

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--small", "--rounds", "4", "--n-train", "2048",
         "--n-test", "512", "--batch-size", "64"]


@pytest.mark.parametrize("arch,protocol,extra", [
    ("wdl-criteo", "celu", []),
    ("wdl-criteo", "celu", ["--no-cache-fusion"]),
    ("dssm-avazu", "fedbcd", []),
    ("wdl-criteo", "vanilla", []),
    ("wdl-criteo", "celu", ["--opt-state-dtype", "bfloat16"]),
    ("wdl-criteo", "celu", ["--opt-state-dtype", "int8"]),
    ("dssm-avazu", "celu", ["--opt-state-dtype", "int8"]),
    ("wdl-criteo", "celu", ["--optimizer", "sm3"]),
])
def test_cli_runs_rounds_on_cpu(arch, protocol, extra):
    out = train.main(["--arch", arch, "--protocol", protocol] + SMALL
                     + extra)
    assert out["device"] == "cpu"
    assert np.isfinite(out["final_loss"])
    assert 0.0 <= out["final_auc"] <= 1.0
    # fp32 wire: one (B, z_dim) Z up and one ∇Z down per round
    assert out["comm_bytes"] == 4 * 2 * 64 * 32 * 4


@pytest.mark.parametrize("flag", [
    ["--pipeline-depth", "1"], ["--pipeline-depth", "2"],
    ["--fault-drop-prob", "0.1"],
    ["--checkpoint", "x.npz"], ["--resume", "x.npz"],
    ["--fault-straggler-prob", "0.1"], ["--fault-dropout", "1:0:5"],
])
def test_cli_refuses_flags_of_later_slices(flag, capsys, tmp_path):
    """The flags of the pipelined scheduler (slice 2) and of chaos and
    checkpoints (slice 6), once refused, now run and do what the
    reference's do.  The pipeline depths: every round is merged, the
    queue drains, and the WAN clock charges the overlap.  A fault flag
    builds the reference's ``FaultPlan`` and runs the chaos engine, whose
    wire is charged per attempt (a malformed ``--fault-dropout`` is
    refused with the reference's message); ``--checkpoint`` writes a
    round-state file; ``--resume`` continues one bitwise."""
    if flag[0] in ("--checkpoint", "--resume"):
        flag = [flag[0], str(tmp_path / flag[1])]
    if flag[0] == "--fault-dropout":
        with pytest.raises(SystemExit, match="PARTY:START:ROUNDS"):
            train.main(["--arch", "wdl-criteo"] + SMALL + flag)
        flag = ["--fault-dropout", "a0:1:2"]
    if flag[0] == "--resume":
        train.main(["--arch", "wdl-criteo"] + SMALL
                   + ["--rounds", "2", "--pipeline-depth", "1",
                      "--checkpoint", flag[1], "--checkpoint-every", "2"])
        whole = train.main(["--arch", "wdl-criteo"] + SMALL
                           + ["--pipeline-depth", "1"])
        out = train.main(["--arch", "wdl-criteo"] + SMALL
                         + ["--pipeline-depth", "1"] + flag)
        assert out["start_round"] == 2
        assert "[resume]" in capsys.readouterr().out
        assert out["history"] == whole["history"][1:]
        assert out["final_auc"] == whole["final_auc"]
        return
    if flag[0] == "--checkpoint":
        from repro_torch import checkpoint as ckpt
        out = train.main(["--arch", "wdl-criteo"] + SMALL + flag
                         + ["--checkpoint-every", "2"])
        assert ckpt.peek_pending_len(flag[1]) == 0   # depth 0: none
        assert out["fault_telemetry"] is None
        assert out["comm_bytes"] == 4 * 2 * 64 * 32 * 4
        # the scheduler object a checkpoint needs is bitwise make_round
        plain = train.main(["--arch", "wdl-criteo"] + SMALL)
        assert out["history"] == plain["history"]
        return
    out = train.main(["--arch", "wdl-criteo"] + SMALL + flag)
    assert np.isfinite(out["final_auc"])
    if flag[0].startswith("--fault"):
        tel = out["fault_telemetry"]
        assert tel["rounds"] == 4
        # the wire is charged per attempt
        assert out["comm_bytes"] == tel["wire_attempts"] * 2 * 64 * 32 * 4
        if flag[0] == "--fault-dropout":
            assert tel["dropout_rounds"] == 2
            assert tel["events"][0] == {"round": 1, "kind": "dropout",
                                        "parties": ["a0"]}
        assert "[chaos]" in capsys.readouterr().out
        return
    depth = int(flag[1])
    assert out["pipeline_depth"] == depth
    assert np.isfinite(out["final_loss"])
    assert out["comm_bytes"] == 4 * 2 * 64 * 32 * 4
    assert out["sim_wan_s"] < out["sim_wan_sequential_s"]
    done = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[done]")]
    assert len(done) == 1 and "sequential would be" in done[0] \
        and "overlap win" in done[0], done


def _reference_plan(args):
    """The reference CLI's ``FaultPlan`` of the same parsed flags, with
    its dataclasses turned into the port's for comparison."""
    import dataclasses

    from repro.launch.train import _fault_plan_from_args
    from repro_torch.configs.base import DropoutSpan, FaultPlan
    plan = _fault_plan_from_args(args)
    if plan is None:
        return None
    return FaultPlan(**{**dataclasses.asdict(plan), "dropouts": tuple(
        DropoutSpan(**dataclasses.asdict(d)) for d in plan.dropouts)})


@pytest.mark.parametrize("optimizer", ["sgd", "adam", "sm3"])
def test_cli_opt_state_dtype_needs_adagrad(optimizer):
    """As the reference's ``make_opt``: the at-rest state dtype routes
    AdaGrad only."""
    with pytest.raises(SystemExit, match="requires --optimizer adagrad"):
        train.main(["--arch", "wdl-criteo", "--optimizer", optimizer,
                    "--opt-state-dtype", "int8"] + SMALL)


@pytest.mark.parametrize("optimizer,state_dtype", [
    ("adagrad", "float32"), ("adagrad", "bfloat16"), ("adagrad", "int8"),
    ("sm3", "float32")])
def test_cli_reports_opt_state_bytes(optimizer, state_dtype, capsys):
    """The ``[opt]`` line counts both parties' optimizer state as the
    reference's ``opt_state_nbytes`` does, at the ``--small`` widths."""
    import dataclasses

    import jax
    from repro.configs import get_config
    from repro.models.tabular import make_dlrm
    from repro.optim import make_optimizer
    from repro.optim.quantized import opt_state_nbytes
    cfg = dataclasses.replace(get_config("wdl-criteo"), vocab=128,
                              embed_dim=8, z_dim=32, hidden=(64, 32))
    init_fn, _, _ = make_dlrm(cfg)
    params = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), cfg))
    kw = {} if state_dtype == "float32" else {"state_dtype": state_dtype}
    jopt = make_optimizer(optimizer, 0.01, **kw)
    want = [opt_state_nbytes(jopt, params[p]) for p in ("a", "b")]
    train.main(["--arch", "wdl-criteo", "--optimizer", optimizer,
                "--opt-state-dtype", state_dtype] + SMALL + ["--rounds", "1"])
    out = capsys.readouterr().out
    assert f"Party A {want[0]} B, Party B {want[1]} B" in out, (want, out)


@pytest.mark.parametrize("flag", [
    ["--fault-seed", "3"], ["--fault-max-retries", "1"],
    ["--fault-straggler-rounds", "1"], ["--checkpoint-every", "10"],
    ["--pipeline-lr-damping", "0.5"],
])
def test_cli_rejects_tuning_flags_of_later_slices(flag, capsys, tmp_path):
    """The reference's flags that tune the chaos engine and the
    checkpoints, once undefined, are accepted with the reference's
    defaults and tune what the reference's tune: each fault flag lands in
    the same ``FaultPlan`` as the reference CLI's and the run's events
    follow that plan's fates; ``--checkpoint-every`` sets the rounds a
    checkpoint is written at.  ``--pipeline-lr-damping`` tunes the
    pipelined scheduler: it is accepted, and damps a depth-2 run's
    updates."""
    if flag[0] == "--pipeline-lr-damping":
        runs = [train.train_dlrm(train.build_parser().parse_args(
            ["--arch", "wdl-criteo"] + SMALL
            + ["--rounds", "6", "--pipeline-depth", "2",
               "--pipeline-lr-damping", c]))
            for c in (flag[1], "0")]
        for out in runs:
            assert np.isfinite(out["final_loss"])
        # the same schedule, damped and not: the losses part once a
        # damped update reaches a dispatched exchange (round 4 on)
        assert runs[0]["final_loss"] != runs[1]["final_loss"]
        return
    defaults = train.build_parser().parse_args(["--arch", "wdl-criteo"])
    assert (defaults.fault_seed, defaults.fault_max_retries,
            defaults.fault_straggler_rounds, defaults.checkpoint_every,
            defaults.fault_drop_prob, defaults.fault_straggler_prob,
            defaults.fault_dropout, defaults.checkpoint,
            defaults.resume) == (0, 2, 2, 50, 0.0, 0.0, [], "", "")
    if flag[0] == "--checkpoint-every":
        from repro_torch import checkpoint as ckpt
        path = str(tmp_path / "c.npz")
        for rounds, saved in (("9", False), ("10", True)):
            train.main(["--arch", "wdl-criteo"] + SMALL
                       + ["--rounds", rounds, "--checkpoint", path] + flag)
            assert (tmp_path / "c.npz").exists() == saved
        assert ckpt.peek_pending_len(path) == 0
        return
    from repro_torch.core.faults import FaultSchedule
    argv = (["--arch", "wdl-criteo"] + SMALL
            + ["--rounds", "8", "--fault-drop-prob", "0.4",
               "--fault-straggler-prob", "0.5", "--pipeline-depth", "1"]
            + flag)
    args = train.build_parser().parse_args(argv)
    plan = train.fault_plan(args)
    assert plan == _reference_plan(args)
    assert getattr(plan, {"--fault-seed": "seed",
                          "--fault-max-retries": "max_retries",
                          "--fault-straggler-rounds": "straggler_rounds"}[
        flag[0]]) == int(flag[1])
    tel = train.main(argv)["fault_telemetry"]
    fates = [FaultSchedule(plan).exchange_fate(t) for t in range(8)]
    drops = [e["round"] for e in tel["events"] if e["kind"] == "drop"]
    assert tel["wire_attempts"] >= tel["dispatches"]
    assert all(not fates[t].delivered for t in drops)
    assert all(f.attempts <= plan.max_retries + 1 for f in fates)
    assert all(f.delay_rounds <= plan.straggler_rounds for f in fates)


def test_cli_refuses_llm_arch():
    """The dense LLM archs train here (tests/test_torch_llm_train.py);
    the other families' come with slice 7c."""
    with pytest.raises(SystemExit, match="slice 7"):
        train.main(["--arch", "granite-moe-3b-a800m"] + SMALL)


def test_default_device_is_cuda():
    """Without ``--device`` the CLI asks for the card and raises when
    there is none, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "wdl-criteo", "--small", "--rounds", "1"])
