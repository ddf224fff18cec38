"""The reference and the port at WDL-Criteo's full width, from one init.

Both engines start from the reference's initial parameters (PRNGKey 0,
bridged into the port) and take the same batches at the paper's widths
(B = 256, R = W = 5, celu, AdaGrad lr 0.01, 8,192 training rows) on the
CPU.  Under this lr the first AdaGrad steps move every coordinate by ±lr
whatever its gradient's size, so a rounding-level gradient flips a whole
step: the two agree to float32 rounding for four rounds (loss within
8.6e-8 relative, ``w_mean`` within 2.0e-4), differ by 1.9e-3 in loss at
round 5 and part after the loss spike at round 6.  The test runs five
rounds, prints every deviation and holds the first four.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.configs.base import CELUConfig as JCELU
from repro.core import engine as jengine
from repro.data.synthetic import TABULAR_SPECS, aligned_batches, make_tabular
from repro.models.tabular import make_dlrm as jmake_dlrm
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.bridge import load_tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import CELUConfig as TCELU
from repro_torch.core import engine as tengine
from repro_torch.data import to_device
from repro_torch.models.tabular import make_dlrm as tmake_dlrm
from repro_torch.optim import make_optimizer as tmake_optimizer

torch.set_num_threads(1)

ROUNDS = 5
HELD = 4
LOSS_RTOL = 1e-6
W_MEAN_ATOL = 1e-3


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_full_width_rounds_match_reference():
    spec = dataclasses.replace(TABULAR_SPECS["criteo"], n_train=8192,
                               n_test=1024)
    data = make_tabular(spec, 0)
    cfg = get_config("wdl-criteo")
    tcfg = tget_config("wdl-criteo")
    jinit, jtask, _ = jmake_dlrm(cfg)
    tinit, ttask, _ = tmake_dlrm(tcfg)
    jparams = jinit(jax.random.PRNGKey(0), cfg)
    tparams = tinit(0, tcfg, "cpu")
    for party in ("a", "b"):
        load_tree(tparams[party],
                  jax.tree_util.tree_map(np.asarray, jparams[party]))
    jopt = jmake_optimizer("adagrad", 0.01)
    topt = tmake_optimizer("adagrad", 0.01)
    jtask = jengine.lift_two_party(jtask)
    ttask = tengine.lift_two_party(ttask)

    _, ba, bb = next(aligned_batches(data["train"], 256, seed=0))
    jstate = jengine.init_state(jtask,
                                jengine.lift_two_party_params(jparams),
                                jopt, JCELU(), [_jax(ba)], _jax(bb))
    tstate = tengine.init_state(ttask,
                                tengine.lift_two_party_params(tparams),
                                topt, TCELU(), [to_device(ba, "cpu")],
                                to_device(bb, "cpu"))
    jround = jengine.make_round(jtask, jopt, JCELU())
    tround = tengine.make_round(ttask, topt, TCELU())
    it = aligned_batches(data["train"], 256, seed=0)
    loss_dev, w_dev = [], []
    for _ in range(ROUNDS):
        bi, ba, bb = next(it)
        jstate, jm = jround(jstate, [_jax(ba)], _jax(bb), bi)
        tstate, tm = tround(tstate, [to_device(ba, "cpu")],
                            to_device(bb, "cpu"), bi)
        assert int(tm["local_steps"]) == int(jm["local_steps"])
        loss_dev.append(abs(float(tm["loss"]) - float(jm["loss"]))
                        / abs(float(jm["loss"])))
        w_dev.append(abs(float(tm["w_mean"]) - float(jm["w_mean"])))
    print(f"loss rel dev {loss_dev}; w_mean abs dev {w_dev}")
    assert max(loss_dev[:HELD]) <= LOSS_RTOL, loss_dev
    assert max(w_dev[:HELD]) <= W_MEAN_ATOL, w_dev
