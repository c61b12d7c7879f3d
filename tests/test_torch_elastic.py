"""``runtime.elastic.reshard_state`` against the JAX package's, on the CPU.

A 2x4 grid of spawned gloo ranks (``tests/_torch_grid.py``) saves a
state of four leaves with ``checkpoint.CheckpointManager``, restores it
whole, loses rank 5 and cuts the restored state onto the surviving 1x4
grid. JAX does the same on 8 fake CPU devices: ``surviving_mesh`` after
the device at mesh position (1, 1) fails, then ``reshard_state`` with the
same ``PartitionSpec``s. Each survivor's blocks equal JAX's shards at the
same mesh position, bit for bit (blocks are held by grid position, not
by device id); the ranks outside the grid get None. A 4x2 grid that
loses a rank keeps 3 rows, and a batch of 4 split over them is refused
by both packages.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_grid import run_grid  # noqa: E402
from test_torch_harness import run_reference  # noqa: E402

SPECS = {"batch": ("data", None), "cols": (None, "model"),
         "both": ("data", "model"), "scalar": ()}
SHAPES = {"batch": (4, 6), "cols": (3, 8), "both": (2, 12), "scalar": ()}
# (grid, the dead rank: its mesh position)
SHRINK = ((2, 4), 5)
REFUSED = ((4, 2), 3)

REFERENCE = """
import json

import jax
from jax.sharding import PartitionSpec as P
from repro.runtime import elastic

specs = {k: P(*v) for k, v in json.loads(str(IN["specs"])).items()}
state = {k: IN["leaf_" + k] for k in specs}


def shrink(shape, dead):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"))
    pos = divmod(dead, shape[1])
    fleet = elastic.fail_hosts(elastic.initial_fleet(mesh),
                               [mesh.devices[pos].id])
    return elastic.surviving_mesh(fleet)


(shape, dead) = json.loads(str(IN["shrink"]))
new = shrink(shape, dead)
OUT["new_shape"] = np.array(new.devices.shape)
where = {d.id: idx for idx, d in np.ndenumerate(new.devices)}
out = elastic.reshard_state(state, specs, new)
for k, arr in out.items():
    for shard in arr.addressable_shards:
        a, b = where[shard.device.id]
        OUT[f"{k}@{a},{b}"] = np.asarray(shard.data)

(shape, dead) = json.loads(str(IN["refused"]))
new = shrink(shape, dead)
OUT["refused_shape"] = np.array(new.devices.shape)
try:
    elastic.reshard_state({"batch": IN["leaf_batch"]},
                          {"batch": specs["batch"]}, new)
    OUT["refused"] = "accepted"
except Exception as e:
    OUT["refused"] = f"{type(e).__name__}: {e}"
"""


def _leaves():
    rng = np.random.default_rng(0)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inputs = dict(specs=np.array(json.dumps(SPECS)),
                  shrink=np.array(json.dumps(SHRINK)),
                  refused=np.array(json.dumps(REFUSED)),
                  **{"leaf_" + k: v for k, v in _leaves().items()})
    return run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("ref"),
                         n_devices=8)


def _run(case, tmp_path_factory, leaves):
    (pr, pc), dead = case
    work = tmp_path_factory.mktemp(f"grid{pr}x{pc}")
    return run_grid(pr, pc, [("reshard", "reshard", dict(
        dead=[dead], leaves=leaves, specs=SPECS if len(leaves) > 1 else
        {"batch": SPECS["batch"]}, ckdir=str(work / "ckpt")))], work)


@pytest.fixture(scope="module")
def shrunk(tmp_path_factory):
    return _run(SHRINK, tmp_path_factory, _leaves())


def test_survivors_blocks_equal_jax_shards(ref, shrunk):
    assert tuple(ref["new_shape"]) == (1, 4)
    for rank, res in enumerate(shrunk):
        got = res["reshard"]
        if rank >= 4:  # row 1 lost rank 5: outside the surviving grid
            assert got is None, (rank, got)
            continue
        assert not (isinstance(got, tuple) and got[0] == "raised"), got
        (pr, pc, a, b), blocks = got
        assert (pr, pc, a, b) == (1, 4, 0, rank)
        assert set(blocks) == set(SPECS)
        for k, blk in blocks.items():
            want = ref[f"{k}@{a},{b}"]
            assert blk.dtype == want.dtype and blk.shape == want.shape, k
            assert blk.tobytes() == want.tobytes(), (rank, k)


def test_blocks_tile_the_whole_leaves(shrunk):
    leaves = _leaves()
    blocks = [r["reshard"][1] for r in shrunk[:4]]
    np.testing.assert_array_equal(
        np.concatenate([b["cols"] for b in blocks], axis=1), leaves["cols"])
    for b in blocks:
        np.testing.assert_array_equal(b["batch"], leaves["batch"])
        assert b["scalar"] == leaves["scalar"]


def test_a_batch_that_the_new_rows_do_not_divide_is_refused(
        ref, tmp_path_factory):
    assert tuple(ref["refused_shape"]) == (3, 2)
    jax_says = str(ref["refused"])
    assert jax_says.startswith("ValueError") and "divisible by 3" in jax_says
    res = _run(REFUSED, tmp_path_factory, {"batch": _leaves()["batch"]})
    for rank, r in enumerate(res):
        got = r["reshard"]
        if rank in (2, 3):  # the row that lost rank 3
            assert got is None
            continue
        assert got[:2] == ("raised", "ValueError"), got
        assert "divisible by 3" in got[2] and "equal to 4" in got[2], got


def test_reshard_state_in_process():
    """One gloo rank: the 1x1 grid keeps every leaf whole, on its device,
    as a copy; specs follow the state's tree, named tuples included; a
    rank outside the grid gets None."""
    import torch

    from repro_torch.core import make_grid
    from repro_torch.runtime import elastic
    from repro_torch.training import OptState

    grid = make_grid(1, 1, device="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    st = OptState(torch.tensor(2, dtype=torch.int32), {"w": x}, {"w": x * 2})
    spec = OptState((), {"w": ("data", "model")}, {"w": (None,)})
    out = elastic.reshard_state(st, spec, grid)
    assert isinstance(out, OptState) and int(out.step) == 2
    assert torch.equal(out.m["w"], x) and torch.equal(out.v["w"], x * 2)
    assert out.m["w"].data_ptr() != x.data_ptr()
    blk = elastic.reshard_state({"a": np.ones((2, 2))}, {"a": ("data",)},
                                grid)
    assert torch.is_tensor(blk["a"]) and blk["a"].shape == (2, 2)
    assert elastic.reshard_state(st, spec, None) is None
    with pytest.raises(ValueError, match="'data' or 'model'"):
        elastic.reshard_state({"a": x}, {"a": ("pod",)}, grid)
    with pytest.raises(ValueError, match="entries"):
        elastic.reshard_state({"a": x}, {"a": (None, None, None)}, grid)
