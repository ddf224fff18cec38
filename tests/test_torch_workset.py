"""The port's workset ring against the reference, exactly.

A scripted run of inserts and draws goes through ``repro.core.workset``
and ``repro_torch.core.workset`` side by side; after every operation the
slot, the valid flag, the batch index, the use counts, the insertion
times, the cursor and the clock must be equal, and so must the entry a
draw materialises (a copy, so bitwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import workset as jws
from repro_torch.core import workset as tws

torch.set_num_threads(1)


def _entry(rng, B=4, F=3):
    z = rng.standard_normal((B, F)).astype(np.float32)
    dz = rng.standard_normal((B, F)).astype(np.float32)
    x = rng.integers(0, 9, size=(B, 2)).astype(np.int32)
    return {"z": z, "dz": dz, "batch": {"x": x}}


def _to_jax(e):
    return {"z": jnp.asarray(e["z"]), "dz": jnp.asarray(e["dz"]),
            "batch": {"x": jnp.asarray(e["batch"]["x"])}}


def _to_torch(e):
    return {"z": torch.from_numpy(e["z"]), "dz": torch.from_numpy(e["dz"]),
            "batch": {"x": torch.from_numpy(e["batch"]["x"]).long()}}


def _clocks_equal(j, t):
    for k in ("insert_time", "use_count", "batch_idx", "cursor", "time"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                      err_msg=k)


# (W, R, strategy, draws per insert): the paper's round-robin ring with
# bubbles and exhaustion, and FedBCD's consecutive draw
SCRIPTS = [(3, 2, "round_robin", 3), (5, 5, "round_robin", 5),
           (3, 2, "round_robin", 1), (1, 5, "consecutive", 5),
           (4, 3, "consecutive", 2)]


@pytest.mark.parametrize("W,R,strategy,draws", SCRIPTS)
def test_scripted_inserts_and_draws_match_reference(W, R, strategy, draws):
    rng = np.random.default_rng(W * 10 + R)
    e0 = _entry(rng)
    jw = jws.workset_init(W, _to_jax(e0))
    tw = tws.workset_init(W, _to_torch(e0))
    _clocks_equal(jw, tw)
    for t in range(2 * W + 1):
        e = _entry(rng)
        jw = jws.workset_insert(jw, _to_jax(e), 100 + t)
        tw = tws.workset_insert(tw, _to_torch(e), 100 + t)
        _clocks_equal(jw, tw)
        for _ in range(draws):
            jw, jslot, jbi, jvalid = jws.workset_draw(jw, R, strategy)
            tw, tslot, tbi, tvalid = tws.workset_draw(tw, R, strategy)
            assert int(tslot) == int(jslot)
            assert bool(tvalid) == bool(jvalid)
            assert int(tbi) == int(jbi)
            _clocks_equal(jw, tw)
            tentry = tws.workset_entry(tw, tslot)
            jentry = jws.workset_entry(jw, jslot)
            for k in ("z", "dz"):
                np.testing.assert_array_equal(tentry[k].numpy(),
                                              np.asarray(jentry[k]))
            np.testing.assert_array_equal(tentry["batch"]["x"].numpy(),
                                          np.asarray(jentry["batch"]["x"]))
        js = jws.workset_stats(jw, R)
        ts = tws.workset_stats(tw, R)
        assert {k: int(v) for k, v in ts.items()} == \
            {k: int(v) for k, v in js.items()}
    assert tws.workset_nbytes(tw) == jws.workset_nbytes(jw) + \
        W * 4 * 2 * 4     # the port caches ids as int64


def test_unported_workset_paths_raise():
    e = _to_torch(_entry(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="cache_dtype"):
        tws.workset_init(3, e, cache_dtype="int2")
    # a quantised table draws its rounding uniforms from a key
    with pytest.raises(ValueError, match="needs a key"):
        tws.workset_insert(tws.workset_init(3, e, cache_dtype="int8"), e, 0)
    # uniform sampling is in: it needs a key, and draws a 0-d int32 slot
    # among the alive ones as the reference's categorical draw does
    # (tests/test_torch_pipeline.py holds it to the reference)
    from test_torch_compression import jax_uniforms
    from repro_torch.core.uniforms import draw_key
    ws = tws.workset_init(3, e)
    with pytest.raises(ValueError, match="rng"):
        tws.workset_draw(ws, 2, "uniform")
    tws.workset_insert(ws, e, 7)
    _, slot, bi, valid = tws.workset_draw(
        ws, 2, "uniform", rng=draw_key(jax_uniforms, 0, 0, 0))
    assert slot.dtype == torch.int32 and slot.dim() == 0
    assert (int(slot), int(bi), bool(valid)) == (0, 7, True)
    assert ws["use_count"].tolist() == [1, 0, 0]
    assert int(ws["cursor"]) == 0
