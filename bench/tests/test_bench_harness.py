"""The benchmark's data files, its arithmetic and its readers, on the CPU."""
import json
import math
import os
import re

import pytest
import torch

from bench import flops, peaks, shares, specs, tiny
from bench import trace as T
from bench import weights as Wt
from bench.harness import Run

ROOT = specs.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[kind]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))
    assert all(UNIT.match(m["unit"]) for m in
               BENCH["end_to_end"] + BENCH["per_layer"])
    assert "setup_s" in ms
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_parse_and_agree(cell):
    c = specs.load_cell(cell)
    entry = c["entry"]
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    conf = [x for x in BENCH["configs"] if x["name"] == entry["config"]][0]
    assert conf["file"] == f"bench/configs/{entry['config']}.json"
    assert conf["reduced"] == c["config"]["reduced"]
    assert conf["source"] == c["config"]["source"]
    from bench import check
    assert set(c["limits"]) == set(check.NUMBERS)
    for m in specs.metrics_for(BENCH, cell, "end_to_end") + \
            specs.metrics_for(BENCH, cell, "per_layer"):
        assert callable(specs.reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_config_file_is_the_programs_config(cell):
    """The configuration as run is the program's own (``configs/``)."""
    from bench import program
    from repro_torch.configs import get_config
    c = specs.load_cell(cell)["config"]
    mine, port = program.arch_config(c), get_config(c["port"]["arch"])
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "resolved_head_dim", "aux_vocab_size",
              "rope_theta", "vfl_split", "moe"):
        assert getattr(mine, f) == getattr(port, f), f
    # the published epsilon, which the program takes from the file
    assert mine.norm_eps == float(c["rms_norm_eps"])


@pytest.mark.parametrize("cell", CELLS)
def test_weight_layout_is_the_programs(cell):
    """Every leaf the benchmark draws has the path, shape and dtype of the
    program's own tree (built on the meta device)."""
    from bench import program
    from repro_torch.launch.budget import _param_shapes
    from repro_torch.models import vfl
    c = specs.load_cell(cell)["config"]
    tree = _param_shapes(program.arch_config(c))
    for party, leaves in Wt.leaf_specs(c).items():
        port = {n: (tuple(t.shape), t.dtype) for n, t in
                vfl.PartyParams(tree[party]).named_parameters()}
        mine = {s[0]: (tuple(s[1]), s[2]) for s in leaves}
        assert mine == port


def test_weights_redraw_bitwise_and_differ_by_seed():
    c = tiny.tiny_cell()["config"]
    a = Wt.make_party_trees(c, 2 ** 31 + 7, "cpu")
    b = Wt.make_party_trees(c, 2 ** 31 + 7, "cpu")
    d = Wt.make_party_trees(c, 2 ** 31 + 8, "cpu")
    assert torch.equal(a["b"]["head"], b["b"]["head"])
    assert not torch.equal(a["b"]["head"], d["b"]["head"])
    for party, spec in Wt.iter_leaves(c):
        t = Wt.draw_leaf(2 ** 31 + 7, party, spec, "cpu")
        assert Wt.change_norm(2 ** 31 + 7, party, spec, t) == 0.0


def test_traffic_is_seeded_and_rows_differ():
    t = tiny.tiny_cell()["traffic"]
    from bench import traffic as Tr
    x = Tr.make_batches(t, 500, 512, 2 ** 32 + 3, "cpu")
    y = Tr.make_batches(t, 500, 512, 2 ** 32 + 3, "cpu")
    assert len(x) == t["n_batches"]
    for (a1, b1), (a2, b2) in zip(x, y):
        assert torch.equal(b1["tokens"], b2["tokens"])
        assert int(b1["tokens"].max()) < 500
        assert int(a1["tokens_a"].max()) < 512
        assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    rows = torch.cat([b["tokens"] for _, b in x])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]


def test_flops_against_a_hand_count():
    """d 8, 2 heads of 4 (1 KV head), f 16, vocab 10, one layer a tower,
    B 2, S 3, R 1."""
    g = {"d": 8, "H": 2, "Kv": 1, "hd": 4, "f": 16, "E": 0, "top_k": 0,
         "vocab": 10, "layers": {"a": 1, "bottom": 1, "top": 1}}
    lay = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8 + 3 * 8 * 16      # 576
    T_ = 6
    attn = 2 * 3 * 8 * T_                                  # 288
    fa = 2 * lay * T_ + attn                               # 7,200
    after = 64 + lay + 80                                  # 720
    fb = 2 * (lay + after) * T_ + 2 * attn                 # 16,128
    adhoc = 2 * after * T_ + 2 * attn                      # 9,216
    want = 3 * (fa + fb) + 3 * fa + (fb + adhoc + 3 * fb)
    got = flops.round_flops(g, 2, 3, 1)
    assert (got["fwd_a"], got["fwd_b"], got["adhoc_bwd_b"]) == \
        (fa, fb, adhoc)
    assert got["round"] == want
    moe = dict(g, E=4, top_k=2)
    assert flops.layer_params(moe) == 192 + 8 * 4 + 2 * 3 * 8 * 16


def _us(rf_cost, flop_peak=peaks.BF16_FLOPS):
    return 1e6 * shares.least_s(*rf_cost, flop_peak)


def test_rooflines_reproduce_the_kernel_tables_bounds():
    """PERF.md's kernel table, Bound column, at its shapes."""
    fwd = specs.roofline("flash_fwd")
    dkv = specs.roofline("flash_bwd_dkv")
    dq = specs.roofline("flash_bwd_dq")
    gate = specs.roofline("gate")
    ag = specs.roofline("adagrad")
    assert _us(fwd.cost(1, 4096, 15, 64, 2, True)) == \
        pytest.approx(32.578, abs=5e-4)
    assert _us(dkv.cost(1, 4096, 15, 64, 2, True)) == \
        pytest.approx(65.157, abs=5e-4)
    assert _us(dq.cost(1, 4096, 15, 64, 2, True)) == \
        pytest.approx(48.868, abs=5e-4)
    assert _us(gate.cost(2, 3_932_160, 2, True), peaks.FP32_FLOPS) == \
        pytest.approx(28.171, abs=5e-4)
    assert _us(gate.cost(2, 3_932_160, 2, False), peaks.FP32_FLOPS) == \
        pytest.approx(14.085, abs=1e-3)
    from repro_torch.bridge import reference_parameters
    from repro_torch.configs import get_config
    from repro_torch.models.tabular import make_dlrm
    cfg = get_config("wdl-criteo")
    wdl = make_dlrm(cfg)[0](0, cfg, "cpu")
    rows = [(t.numel(), 4, 4, 4) for t in reference_parameters(wdl["a"])]
    assert _us(ag.cost(rows), peaks.FP32_FLOPS) == \
        pytest.approx(4.995, abs=5e-4)


def _profile():
    """Two rounds: in each, 2R K1 calls on the split-row path (R = 5),
    12 K7 launches, one fwd / dkv / dq launch, a copy; 1 ms idle."""
    dev, t = [], 0.0

    def add(name, us):
        nonlocal t
        dev.append((name, t, t + us))
        t += us
    for _ in range(2):
        for _ in range(10):
            add("void gate_partials_kernel<Dense<bf16>, 4>(GateArgs)", 20.0)
            add("void gate_apply_kernel<Dense<bf16>, 4>(GateArgs)", 10.0)
        for _ in range(12):
            add("void fused_adagrad_kernel(K7Table, float const*)", 100.0)
        add("void flash_fwd_mma<64>(bf16 const*)", 300.0)
        add("void flash_bwd_dkv_mma<64>(bf16 const*)", 600.0)
        add("void flash_bwd_dq_f32mma<64>(float const*)", 900.0)
        add("Memcpy DtoD (Device -> Device)", 50.0)
        t += 1000.0
    host = [("aten::mm", 0.0, t), ("cudaLaunchKernel", 1000.0, t)]
    return T.Profile(rounds=2, wall_s=t / 1e6, device=dev, host=host)


def _run(profile, cell="granite-moe-3b-a800m.s4k"):
    c = specs.load_cell(cell)
    return Run(config=c["config"], geometry=Wt.geometry(c["config"]),
               traffic=c["traffic"], setup_s=30.0, round_s=[2.0, 2.0],
               window_s=4.0, peak_bytes=3 * 2 ** 30, profile=profile)


def test_readers_on_a_synthetic_profile():
    p = _profile()
    run = _run(p)
    busy = 2 * (10 * 30 + 1200 + 1800 + 50)
    assert p.busy_s() == pytest.approx(busy / 1e6)
    read = {m: specs.reader(m)(run) for m in (
        "round_ms", "peak_mem_gib", "setup_s", "device_idle_pct",
        "launches_per_round", "train_mfu", "gate_roofline",
        "adagrad_roofline", "attention_roofline")}
    assert read["round_ms"] == 2000.0
    assert read["peak_mem_gib"] == 3.0
    assert read["device_idle_pct"] == pytest.approx(
        100 * (1 - busy / 2 / 2e6))
    assert read["launches_per_round"] == 20 + 12 + 3
    g, t = run.geometry, run.traffic
    f = flops.round_flops(g, t["batch"], t["seq_len"], t["R"])["round"]
    assert read["train_mfu"] == pytest.approx(100 * f / (2.0 * 989e12))
    gate = specs.roofline("gate")
    F = t["seq_len"] * g["d"]
    least = 5 * 2 * sum(shares.least_s(*gate.cost(1, F, 2, c),
                                       peaks.FP32_FLOPS) for c in (1, 0))
    assert read["gate_roofline"] == pytest.approx(100 * least / 600e-6)
    fwd, dkv, dq = (specs.roofline(k) for k in
                    ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
    shape = (1, 4096, g["H"], g["hd"])
    least = 2 * (shares.least_s(*fwd.cost(*shape, 2, True), 989e12)
                 + shares.least_s(*dkv.cost(*shape, 2, True), 989e12)
                 + shares.least_s(*dq.cost(*shape, 4, True), 989e12))
    assert read["attention_roofline"] == pytest.approx(100 * least / 3.6e-3)
    assert 0 < read["adagrad_roofline"]
    gaps = T.idle_gaps(p)
    assert gaps[0][0] == "cudaLaunchKernel"
    assert sum(s for _, s in gaps) == pytest.approx(1000e-6 / 2 * 1)
    ops = T.top_device_ops(p)
    assert ops[0] == ["void fused_adagrad_kernel(K7Table, float const*)",
                      pytest.approx(1200e-6)]


def test_readers_read_nothing_without_their_launches():
    p = T.Profile(rounds=1, wall_s=1.0,
                  device=[("void some_kernel()", 0.0, 10.0)], host=[])
    run = _run(p, "smollm-360m.s2k")
    for m in ("gate_roofline", "adagrad_roofline", "attention_roofline"):
        assert specs.reader(m)(run) is None
    run.profile = None
    for m in ("device_idle_pct", "launches_per_round"):
        assert specs.reader(m)(run) is None


def test_no_share_passes_100_on_kernels_at_their_bound():
    """A launch timed at exactly its least time reads 100 %."""
    fwd = specs.roofline("flash_fwd")
    us = _us(fwd.cost(1, 4096, 24, 64, 2, True))
    p = T.Profile(rounds=1, wall_s=1.0,
                  device=[("flash_fwd_mma<64>", 0.0, us)], host=[])
    run = _run(p)
    assert specs.reader("attention_roofline")(run) == pytest.approx(100.0)
    assert math.isfinite(us)
