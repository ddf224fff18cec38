"""The port's training CLI on the CPU: a few rounds end to end (every
optimizer state, the pipelined scheduler), the flags of later slices
refused, and no silent move to the CPU."""
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
def test_cli_refuses_flags_of_later_slices(flag, capsys):
    """Slice 6's flags are refused with a message.  The pipeline depths,
    refused until the pipelined scheduler came, now run: every round is
    merged, the queue drains, and the WAN clock charges the overlap."""
    if flag[0] != "--pipeline-depth":
        with pytest.raises(SystemExit, match="not in the port yet"):
            train.main(["--arch", "wdl-criteo"] + SMALL + flag)
        return
    out = train.main(["--arch", "wdl-criteo"] + SMALL + flag)
    depth = int(flag[1])
    assert out["pipeline_depth"] == depth
    assert np.isfinite(out["final_loss"])
    assert out["comm_bytes"] == 4 * 2 * 64 * 32 * 4
    assert out["sim_wan_s"] < out["sim_wan_sequential_s"]
    done = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[done]")]
    assert len(done) == 1 and "sequential would be" in done[0] \
        and "overlap win" in done[0], done


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
def test_cli_rejects_tuning_flags_of_later_slices(flag, capsys):
    """The reference's flags that only tune a later slice's feature are
    not defined here, so argparse rejects them rather than ignoring them.
    ``--pipeline-lr-damping`` tunes the pipelined scheduler, which is in:
    it is accepted, and damps a depth-2 run's updates."""
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
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "wdl-criteo"] + SMALL + flag)
    assert e.value.code == 2
    assert f"unrecognized arguments: {flag[0]}" in capsys.readouterr().err


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
