"""The port's dry-run layer (``launch/input_specs.py``, ``launch/dryrun.py``,
``models/act_sharding.py``, ``roofline/analysis.py``'s parsers and
planner, ``roofline/report.py``) against the JAX package's, and its own
checks.

The JAX side runs once in a child process with 512 fake CPU devices:
every (arch, shape, mesh) cell's arguments, specs, per-device argument
bytes and activation policy (84 cells); the ``constrain`` key sequence
of a smoke forward of each family, under a policy whose mapping records
each key it is asked for; the HLO parsers on the fixtures of
``tests/test_dryrun.py``; ``plan_edge_tile`` over a grid with explicit
budgets; and the report's two tables rendered from the port's records.
Every one of those comparisons is exact.

The port's matching cell traces one rank on a ``fake`` default process
group, which a test process that already holds another default group
cannot take: its cases run in a child process of their own
(``_port_child``).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec, shapes_for  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import input_specs as I  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import act_sharding, build_defs, build_loss  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from test_torch_harness import REPO, run_reference  # noqa: E402

MODEL_ARCHS = [a for a in ALL_ARCHS if a != "awpm-matching"]
MESHES = ("single", "multi")

GRAPHS = """
def smoke_graph(arch):
    if arch == "graphcast":
        return G.random_graphcast_batch(120, 12, seed=0)
    return G.random_graph(60, 128, 8, seed=0,
                          coords=arch in ("dimenet", "equiformer-v2"),
                          n_graphs=4, triplets=arch == "dimenet")
"""

PLAN_GRID = [(cap, n, te, vmem)
             for cap in (1, 100, 128, 5000, 70_000)
             for n in (1, 500, 40_000)
             for te in (128, 512, 1000)
             for vmem in (64 * 1024, 227 * 1024, 16 * 2**20)]

HLO_STRINGS = ["f32[2,4,4]", "bf16[8]", "f32[256,7,4096]{2,1,0}, f32[256,7]",
               """
  %ag = f32[16,128]{1,0} all-gather(%x), replica_groups={{0,1}}
  %ar.1 = (f32[4,4]{1,0}, f32[4]{0}) all-reduce(%a, %b), to_apply=%sum
  %a2a = bf16[2,8]{1,0} all-to-all(%y), dimensions={0}
  %st = f32[8]{0} all-reduce-start(%z)
""", "  %cps = (f32[8]{0}, u32[]) collective-permute-start(%x)\n"]

REFERENCE = """
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.configs import ALL_ARCHS, get_config
from repro.configs.base import ShapeSpec, shapes_for
from repro.data import graphs as G
from repro.launch.input_specs import build_cell
from repro.launch.mesh import make_production_mesh
from repro.models import build_defs, build_loss
from repro.models import transformer as T
from repro.models.act_sharding import policy
from repro.models.param import init_params
from repro.models.recsys import bert4rec
from repro.roofline import analysis as A
from repro.roofline import report

exec(str(IN["graphs"]))


def enc(spec):
    if isinstance(spec, dict):
        return {str(k): enc(v) for k, v in spec.items()}
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def key_name(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def leaves(tree, shardings, mesh, prefix):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(flat) == len(shs), (prefix, len(flat), len(shs))
    out = []
    for (path, x), sh in zip(flat, shs):
        spec = tuple(sh.spec)
        dims = list(x.shape)
        per = 1
        for i, d in enumerate(dims):
            e = spec[i] if i < len(spec) else None
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            per *= -(-d // math.prod(mesh.shape[a] for a in axes))
        name = "/".join([prefix] + [key_name(k) for k in path])
        out.append([name, dims, str(x.dtype), enc(spec),
                    per * jnp.dtype(x.dtype).itemsize])
    return out


def policy_of(fn):
    for c in getattr(fn, "__closure__", None) or ():
        if isinstance(c.cell_contents, dict):
            return enc(c.cell_contents)
    return None


cells = {}
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mk == "multi")
    for arch in ALL_ARCHS:
        for s in shapes_for(get_config(arch)):
            c = build_cell(arch, s.name, mesh)
            out = []
            for i, (a, sh) in enumerate(zip(c.args, c.in_shardings)):
                out += leaves(a, sh, mesh, str(i))
            cells[f"{arch}|{s.name}|{mk}"] = dict(
                leaves=out, mode=c.mode, note=c.note,
                policy=policy_of(c.fn))
OUT["cells"] = json.dumps(cells)


class Recording(dict):
    def __init__(self):
        super().__init__()
        self.seen = []

    def get(self, key, default=None):
        self.seen.append(key)
        return None


def keys_of(f):
    rec = Recording()
    with policy(None, rec):
        f()
    return rec.seen


seqs = {}
tok = jnp.asarray(IN["tokens"])
for arch in ("qwen2-0.5b", "qwen2-moe-a2.7b"):
    # unrolled and eager: jax.checkpoint and scan trace a layer once
    cfg = dataclasses.replace(get_config(arch, reduced=True), scan=False,
                              remat=False)
    params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
    seqs[arch + "|forward"] = keys_of(lambda: T.forward(params, tok, cfg))
    _, cache = T.prefill(params, tok, cfg)
    seqs[arch + "|prefill"] = keys_of(lambda: T.prefill(params, tok, cfg))
    seqs[arch + "|decode"] = keys_of(
        lambda: T.decode_step(params, cache, tok[:, :1], 7, cfg))
    seqs[arch + "|loss"] = keys_of(lambda: T.loss_fn(
        params, {"tokens": tok, "labels": tok}, cfg))
cfg = get_config("bert4rec", reduced=True)
params = init_params(build_defs(cfg), jax.random.PRNGKey(0))
seq = jnp.asarray(IN["items"])
seqs["bert4rec|serve"] = keys_of(lambda: bert4rec.serve_scores(params, seq,
                                                               cfg))
seqs["bert4rec|loss"] = keys_of(lambda: build_loss(cfg)(
    params, {"item_seq": seq, "labels": seq,
             "mask": jnp.ones(seq.shape, jnp.float32)}))
for arch in ("graphsage-reddit", "dimenet", "equiformer-v2", "graphcast"):
    cfg = get_config(arch, reduced=True)
    shape = ShapeSpec("molecule", "train", (("d_feat", 8),))
    params = init_params(build_defs(cfg, shape), jax.random.PRNGKey(0))
    gb = jax.tree.map(jnp.asarray, smoke_graph(arch))
    seqs[arch + "|loss"] = keys_of(lambda: build_loss(cfg)(params, gb))
OUT["keyseqs"] = json.dumps(seqs)

fixtures = {name: open(path).read() for name, path in
            json.loads(str(IN["fixtures"])).items()}
strings = json.loads(str(IN["hlo_strings"]))
OUT["parsers"] = json.dumps(
    {"shape_bytes": [A.shape_bytes(s) for s in strings],
     "collective_bytes": [A.collective_bytes(s) for s in strings],
     "fixtures": {k: A.collective_bytes(v) for k, v in fixtures.items()},
     "split": [A._split_tuple_elements(s) for s in
               ["(f32[4]{0}, (u32[], s32[2]), bf16[1,2]{1,0})", "f32[3]"]],
     "start": [A._start_result_bytes(s) for s in
               ["(f32[64,256]{1,0}, f32[512,256]{1,0}, u32[], u32[])",
                "f32[1024]{0}", "(f32[8]{0}, u32[])"]]})
OUT["plans"] = json.dumps([dataclasses.asdict(A.plan_edge_tile(
    cap, n, target_te=te, vmem_limit=v))
    for cap, n, te, v in json.loads(str(IN["plan_grid"]))])

recs = json.loads(str(IN["records"]))
for r in recs:
    if "trace_s" in r:
        r["compile_s"] = r["trace_s"]
OUT["tables"] = json.dumps([report.roofline_table(recs),
                            report.dryrun_table(recs)])
"""


def _port_child(code: str) -> dict:
    """Run ``code`` (which sets ``OUT``, a JSON-able dict) in a fresh
    process with the port importable; returns ``OUT``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    script = ("import json\nOUT = {}\n" + code
              + "\nprint('@@' + json.dumps(OUT))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("@@")][-1]
    return json.loads(line[2:])


def _records_for_report():
    recs = []
    for arch, shape, mk in (("graphsage-reddit", "molecule", "single"),
                            ("bert4rec", "serve_p99", "single"),
                            ("qwen2-0.5b", "decode_32k", "multi"),
                            ("graphcast", "molecule", "multi")):
        recs.append(D.run_cell(arch, shape, mk))
    recs.append({"arch": "bert4rec", "shape": "serve_bulk", "mesh": "single",
                 "chips": 256, "ok": False, "error": "RuntimeError: boom"})
    return recs


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    recs = _records_for_report()
    fixtures = {n: str(REPO / "tests" / "data" / n)
                for n in ("hlo_async_collectives.txt",
                          "hlo_cpu_collectives.txt")}
    inputs = dict(graphs=np.array(GRAPHS),
                  tokens=np.arange(16, dtype=np.int32).reshape(2, 8) % 97,
                  items=np.arange(2 * 16, dtype=np.int32).reshape(2, 16) % 50,
                  fixtures=np.array(json.dumps(fixtures)),
                  hlo_strings=np.array(json.dumps(HLO_STRINGS)),
                  plan_grid=np.array(json.dumps(PLAN_GRID)),
                  records=np.array(json.dumps(recs)))
    out = run_reference(REFERENCE, inputs, tmp_path_factory.mktemp("dryrun"),
                        n_devices=512)
    got = {k: json.loads(str(v)) for k, v in out.items()}
    got["port_records"] = recs
    return got


# ------------------------------ the cells -----------------------------------


def _enc(spec):
    """A spec as JSON; a one-axis tuple is that axis, as JAX's
    ``PartitionSpec`` writes it."""
    if isinstance(spec, dict):
        return {str(k): _enc(v) for k, v in spec.items()}
    if spec is None:
        return None
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, (tuple, list))
            else e for e in tuple(spec)]


def _port_leaves(cell) -> dict:
    """{path: [shape, dtype, spec, per-device bytes]} of a port cell."""
    return {p: [list(t.shape), str(t.dtype)[6:], _enc(s),
                D.shard_bytes(t.shape, t.element_size(), s, cell.mesh)]
            for p, t, s in D.arg_leaves(cell.args, cell.in_specs)}


def _jax_leaves_by_port_path(cfg, jax_leaves) -> dict:
    """JAX's leaves carried to the port's paths: parameters (and m, v)
    through the converter's name map, a stacked LM leaf split by layer,
    a transposed weight's shape and spec reversed."""
    if cfg.family == "lm":
        entries = {key: (n, leaf) for key, n, leaf in convert._lm_entries(cfg)}
    elif cfg.family == "recsys":
        entries = {k: (None, v) for k, v in
                   convert._bert4rec_leaves(cfg).items()}
    elif cfg.family == "gnn":
        entries = {k: (None, v) for k, v in convert._gnn_leaves(cfg).items()}
    else:
        entries = {}
    out = {}
    for path, shape, dtype, spec, per in jax_leaves:
        head, _, rest = path.partition("/")
        sub = None
        if head == "0" and entries:
            sub = ("0/", rest)
        elif head == "1" and rest.split("/")[0] in ("m", "v") and entries:
            sub = (f"1/{rest.split('/')[0]}/", rest.split("/", 1)[1])
        if sub is None:
            out[path] = [shape, dtype, spec, per]
            continue
        n_layers, leaf = entries[sub[1]]
        shape, spec = list(shape), list(spec)
        if n_layers:
            shape, spec = shape[1:], spec[1:]
            per //= n_layers
        if leaf.transpose:
            shape, spec = shape[::-1], spec[::-1]
        for i in range(n_layers or 1):
            name = leaf.name.format(i) if n_layers else leaf.name
            out[sub[0] + name] = [shape, dtype, spec, per]
    return out


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_cell_arguments_specs_and_bytes_equal_jax(ref, arch):
    cfg0 = get_config(arch)
    for mk in MESHES:
        mesh = make_production_mesh(multi_pod=mk == "multi")
        for s in shapes_for(cfg0):
            want = ref["cells"][f"{arch}|{s.name}|{mk}"]
            cell = I.build_cell(arch, s.name, mesh)
            got = _port_leaves(cell)
            exp = _jax_leaves_by_port_path(cell.cfg, [
                [p, sh, dt, _enc(sp), per]
                for p, sh, dt, sp, per in want["leaves"]])
            assert sorted(got) == sorted(exp), (s.name, mk)
            for p in got:
                assert got[p] == exp[p], (s.name, mk, p)
            assert D.argument_bytes(cell) == sum(
                lf[4] for lf in want["leaves"]), (s.name, mk)
            assert (cell.mode, cell.note) == (want["mode"], want["note"])


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_cell_policies_equal_jax_key_by_key(ref, arch):
    for mk in MESHES:
        mesh = make_production_mesh(multi_pod=mk == "multi")
        for s in shapes_for(get_config(arch)):
            want = _enc(ref["cells"][f"{arch}|{s.name}|{mk}"]["policy"])
            cell = I.build_cell(arch, s.name, mesh)
            got = None if cell.policy is None else _enc(cell.policy)
            assert (got is None) == (want is None), (s.name, mk)
            if got is not None:
                assert sorted(got) == sorted(want)
                for key in got:
                    assert got[key] == want[key], (s.name, mk, key)


def test_matching_cells_equal_jax(ref):
    got = _port_child("""
from repro_torch.launch import dryrun as D, input_specs as I
from repro_torch.launch.mesh import make_production_mesh
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mk == "multi")
    for shape in ("match_4m", "match_16m"):
        c = I.build_cell("awpm-matching", shape, mesh)
        OUT[f"{shape}|{mk}"] = dict(
            leaves={p: [list(t.shape), str(t.dtype)[6:],
                        [list(e) if isinstance(e, tuple) else e for e in s],
                        D.shard_bytes(t.shape, t.element_size(), s, mesh)]
                    for p, t, s in D.arg_leaves(c.args, c.in_specs)},
            mode=c.mode, note=c.note, bytes=D.argument_bytes(c),
            policy=c.policy)
""")
    for key, cell in got.items():
        want = ref["cells"][f"awpm-matching|{key}"]
        exp = {p: [sh, dt, sp, per] for p, sh, dt, sp, per in want["leaves"]}
        assert cell["leaves"] == exp, key
        assert cell["bytes"] == sum(lf[4] for lf in want["leaves"])
        assert (cell["mode"], cell["note"]) == (want["mode"], want["note"])
        assert cell["policy"] is None and want["policy"] is None


# ----------------------------- constrain keys --------------------------------


def _keys(f) -> list:
    with act_sharding.policy(None, {}) as pol:
        f()
    return [r[0] for r in pol.log]


def _graphs():
    from repro_torch.data import graphs as G

    ns = {"G": G}
    exec(GRAPHS, ns)
    return ns["smoke_graph"]


def test_constrain_key_sequences_equal_jax(ref):
    from repro_torch.models import transformer as T

    want = ref["keyseqs"]
    tok = torch.arange(16, dtype=torch.int32).reshape(2, 8) % 97
    for arch in ("qwen2-0.5b", "qwen2-moe-a2.7b"):
        cfg = get_config(arch, reduced=True)
        model = build_defs(cfg, device="cpu")
        _, cache = T.prefill(model, tok, cfg)
        got = {
            "forward": _keys(lambda: T.forward(model, tok, cfg)),
            "prefill": _keys(lambda: T.prefill(model, tok, cfg)),
            "decode": _keys(lambda: T.decode_step(model, cache, tok[:, :1],
                                                  7, cfg)),
            "loss": _keys(lambda: T.loss_fn(
                model, {"tokens": tok, "labels": tok}, cfg)),
        }
        for what, keys in got.items():
            assert keys == want[f"{arch}|{what}"], (arch, what)
    cfg = get_config("bert4rec", reduced=True)
    model = build_defs(cfg, device="cpu")
    seq = torch.arange(32, dtype=torch.int32).reshape(2, 16) % 50
    assert _keys(lambda: model.serve_scores(seq)) == want["bert4rec|serve"]
    assert _keys(lambda: build_loss(cfg)(
        model, {"item_seq": seq, "labels": seq,
                "mask": torch.ones(seq.shape)})) == want["bert4rec|loss"]
    smoke_graph = _graphs()
    for arch in ("graphsage-reddit", "dimenet", "equiformer-v2", "graphcast"):
        cfg = get_config(arch, reduced=True)
        shape = ShapeSpec("molecule", "train", (("d_feat", 8),))
        model = build_defs(cfg, shape, device="cpu")
        gb = smoke_graph(arch).to("cpu")
        assert _keys(lambda: build_loss(cfg)(model, gb)) == \
            want[arch + "|loss"], arch


def test_constrain_returns_its_input_and_records_only_under_a_policy():
    x = torch.ones(2, 3, 5)
    assert act_sharding.constrain(x, "mlp_hidden") is x
    assert getattr(act_sharding._tls, "policy", None) is None
    mesh = make_mesh((1, 1), ("data", "model"))
    mapping = {"mlp_hidden": {3: (("data",), None, "model"), 2: None}}
    with act_sharding.policy(mesh, mapping) as pol:
        assert act_sharding.constrain(x, "mlp_hidden") is x
        y = x[0]
        assert act_sharding.constrain(y, "mlp_hidden") is y
        act_sharding.constrain(x, "lm_act")
    assert pol.log == [("mlp_hidden", (2, 3, 5), torch.float32,
                        (("data",), None, "model")),
                       ("mlp_hidden", (3, 5), torch.float32, None),
                       ("lm_act", (2, 3, 5), torch.float32, None)]
    fn = act_sharding.with_policy(mesh, mapping)(
        lambda: act_sharding._tls.policy.mapping)
    assert fn() is mapping
    assert getattr(act_sharding._tls, "policy", None) is None


# ------------------------- parsers, planner, report --------------------------


def _fixture(name):
    return (REPO / "tests" / "data" / name).read_text()


def test_hlo_parsers_equal_jax(ref):
    want = ref["parsers"]
    assert [A.shape_bytes(s) for s in HLO_STRINGS] == want["shape_bytes"]
    assert [A.collective_bytes(s) for s in HLO_STRINGS] == \
        want["collective_bytes"]
    for name, w in want["fixtures"].items():
        assert A.collective_bytes(_fixture(name)) == w, name
    assert [A._split_tuple_elements(s) for s in
            ["(f32[4]{0}, (u32[], s32[2]), bf16[1,2]{1,0})", "f32[3]"]] == \
        want["split"]
    assert [A._start_result_bytes(s) for s in
            ["(f32[64,256]{1,0}, f32[512,256]{1,0}, u32[], u32[])",
             "f32[1024]{0}", "(f32[8]{0}, u32[])"]] == want["start"]
    # the values tests/test_dryrun.py pins
    assert A.shape_bytes("f32[2,4,4]") == 128
    out = A.collective_bytes(_fixture("hlo_cpu_collectives.txt"))
    assert out["bytes"]["all-to-all"] == 4 * (1 * 256 * 4)
    assert all(c == 1 for c in out["counts"].values())
    assert A._is_context_scalar("u32[]") and not A._is_context_scalar("f32[]")


def test_plan_edge_tile_equals_jax_at_explicit_budgets(ref):
    got = [dataclasses.asdict(A.plan_edge_tile(cap, n, target_te=te,
                                               vmem_limit=v))
           for cap, n, te, v in PLAN_GRID]
    assert got == ref["plans"]
    for p in got:
        assert p["te"] % 128 == 0 and p["cap_padded"] % p["te"] == 0
    with pytest.raises(ValueError):
        A.plan_edge_tile(0, 5)


def test_plan_edge_tile_defaults_to_the_h100_shared_memory():
    assert A.plan_edge_tile(5000, 500) == A.plan_edge_tile(
        5000, 500, vmem_limit=A.H100["smem_bytes"])
    big = A.plan_edge_tile(70_000, 40_000)
    assert not big.fits and big.te == 128  # past one block's 227 KB


def test_report_tables_equal_jax_rendering_the_ports_records(ref, tmp_path,
                                                              capsys):
    recs = ref["port_records"]
    rl, dr = ref["tables"]
    assert report.roofline_table(recs) == rl
    # JAX's "compile" column holds the trace's seconds; its header names
    # the HLO, which the port has none of
    assert report.dryrun_table(recs) == dr.replace(
        "| compile | HLO flops/dev | HLO bytes/dev |",
        "| trace | flops/dev | bytes/dev |")
    for r in recs:
        D.save(r, results=tmp_path)
    assert [r["arch"] for r in report.load("single", results=tmp_path)] == \
        ["bert4rec", "bert4rec", "graphsage-reddit"]
    assert report.summary(report.load("multi", results=tmp_path),
                          "multi") == "multi: 2/2 cells OK"
    assert "FAIL bert4rec serve_bulk" in report.summary(
        report.load("single", results=tmp_path), "single")
    assert report.fmt_s(None) == "-" and report.fmt_s(2e-4) == "200us"


# ------------------------------- the trace ----------------------------------


MESH1 = make_mesh((1, 1), ("data", "model"))


def _smoke_cells(attention_impl="torch"):
    lm = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                             attention_impl=attention_impl)
    dims = (("seq_len", 32), ("global_batch", 2))
    out = [I._lm_cells("qwen2-0.5b", lm, ShapeSpec(m, m, dims), MESH1)
           for m in ("train", "prefill", "decode")]
    rc = get_config("bert4rec", reduced=True)
    out.append(I._recsys_cells("bert4rec", rc, ShapeSpec(
        "serve_p99", "serve", (("batch", 4),)), MESH1))
    for arch in ("dimenet", "graphcast"):
        out.append(I._gnn_cells(arch, get_config(arch, reduced=True),
                                ShapeSpec("molecule", "train", (
                                    ("n_nodes", 15), ("n_edges", 32),
                                    ("batch", 4), ("d_feat", 8))), MESH1))
    return out


@pytest.mark.parametrize("i", range(6))
def test_meta_trace_counts_what_a_cpu_run_counts(i):
    from torch.utils.flop_counter import FlopCounterMode

    cell = _smoke_cells()[i]
    meta = D.measure(cell)
    cpu = D.measure(cell, args=I.materialize(cell, "cpu", seed=0))
    with FlopCounterMode(display=False) as fc:
        cell.fn(*I.materialize(cell, "cpu", seed=0))
    assert meta.matmul_flops == fc.get_total_flops() > 0
    assert meta.flops == cpu.flops
    assert meta.output_bytes == cpu.output_bytes
    # the autograd engine frees a few gradient buffers at other moments on
    # another device type (a silu_backward input, 16 KB of the smoke
    # training step's 2 MB); the forward-only steps agree to the byte
    assert abs(meta.temp_bytes - cpu.temp_bytes) <= 0.01 * cpu.temp_bytes
    if cell.mode != "train":
        assert meta.temp_bytes == cpu.temp_bytes


def _cell(step, x):
    return I.Cell("t", "t", "train", step, (x,), ((None,),), MESH1, None,
                  None)


def test_peak_follows_frees_and_autograd_saved_tensors():
    def frees(x):
        a = x * 2  # 4 KB
        b = a + 1  # a and b: 8 KB
        del a
        c = b * 3  # b and c: 8 KB
        del b
        return c.sum()

    tr = D.measure(_cell(frees, torch.empty(1024, device="meta")))
    assert (tr.temp_bytes, tr.output_bytes) == (8192, 4)

    def saved(x):
        y = x.exp()  # saved for backward: it outlives its last name
        z = y.sum()
        del y
        w = x * 2  # y, z and w: 8 KB and 4 B
        del w
        return z

    tr = D.measure(_cell(saved, torch.empty(1024, device="meta",
                                            requires_grad=True)))
    assert (tr.temp_bytes, tr.output_bytes) == (2 * 4096 + 4, 4)


def test_argument_bytes_ceil_divide_over_the_spec():
    mesh = make_mesh((2, 3), ("data", "model"))
    assert D.shard_shape((5, 7), (("data",), "model"), mesh) == (3, 3)
    assert D.shard_bytes((5, 7), 2, (None, ("data", "model")), mesh) == 5 * 2 * 2
    assert D.shard_bytes((), 4, (), mesh) == 4


# ----------------------- reckoned collectives, by rule ------------------------


TINY = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
            d_ff=16, vocab=32, tie_embeddings=True, qkv_bias=False)


def _tiny_lm(mode, b=2, s=4, mesh=None, **kw):
    from repro_torch.configs.base import LMConfig

    cfg = LMConfig("tiny", **{**TINY, **kw})
    mesh = mesh or make_mesh((2, 2), ("data", "model"))
    dims = (("seq_len", s), ("global_batch", b))
    cell = I._lm_cells("tiny", cfg, ShapeSpec(mode, mode, dims), mesh)
    return cell, D.reckon(cell, D.measure(cell).records)


def test_rule_1_fsdp_gathers_once_a_forward_again_under_remat():
    # gathered over "data" (float32): embed [32,8] over model 512, q 128,
    # k 64, v 64, o 128, gate 256, up 256, down 256, 3 norms 32 each
    _, prefill = _tiny_lm("prefill")
    assert prefill["bytes"]["all-gather"] == 1760
    assert prefill["counts"]["all-gather"] == 11
    _, train = _tiny_lm("train")
    assert train["bytes"]["all-gather"] == 2 * 1760
    _, no_remat = _tiny_lm("train", remat=False)
    assert no_remat["bytes"]["all-gather"] == 1760


def test_rule_2_gradients_reduce_scatter_over_the_batch_axes():
    # every parameter holds "data": shards over data x model (or data)
    _, train = _tiny_lm("train")
    assert train["bytes"]["reduce-scatter"] == 880
    assert train["counts"]["reduce-scatter"] == 11
    _, prefill = _tiny_lm("prefill")
    assert prefill["counts"]["reduce-scatter"] == 0
    # no FSDP (d_model 9 does not divide "data"): gradients all-reduced
    cell, r = _tiny_lm("train", d_model=10, mesh=make_mesh(
        (4, 2), ("data", "model")))
    assert r["counts"]["reduce-scatter"] == 0
    grads = sum(D.shard_bytes(p.shape, 4, cell.in_specs[0][n], cell.mesh)
                for n, p in cell.args[0].named_parameters())
    acts = 4 * D.shard_bytes((2, 4, 10), 2, (("data",), None, None),
                             cell.mesh)
    assert r["bytes"]["all-reduce"] == grads + acts


def test_rule_3_tensor_parallel_all_reduces_of_the_activation():
    # [2, 4, 8] bf16 over data: [1, 4, 8] x 2 B = 64 B, twice a layer
    _, prefill = _tiny_lm("prefill")
    assert (prefill["bytes"]["all-reduce"],
            prefill["counts"]["all-reduce"]) == (128, 2)
    _, train = _tiny_lm("train")
    assert (train["bytes"]["all-reduce"], train["counts"]["all-reduce"]) == \
        (256, 4)
    # heads not split (n_heads * hd = 6 does not divide "model" = 4)
    _, none = _tiny_lm("prefill", n_heads=3, head_dim=2,
                       mesh=make_mesh((2, 4), ("data", "model")))
    assert none["counts"]["all-reduce"] == 0


def test_rule_4_expert_all_to_alls():
    from repro_torch.configs.base import MoECfg

    moe = MoECfg(n_experts=4, top_k=2, d_ff_expert=8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    cell, r = _tiny_lm("prefill", b=2, s=4, mesh=mesh, moe=moe)
    assert cell.rules["experts"] == "pod"
    # top-k dispatch in one group: buffer [1, 4, C, 8] bf16 with
    # C = int(1.25 * 2 * 8 / 4) + 1 = 6, sharded (None, pod, data, None)
    c = int(moe.capacity_factor * 2 * 8 / 4) + 1
    per = 1 * 2 * math.ceil(c / 2) * 8 * 2
    assert (r["bytes"]["all-to-all"], r["counts"]["all-to-all"]) == (2 * per, 2)
    _, t = _tiny_lm("train", b=2, s=4, mesh=mesh, moe=moe)
    assert (t["bytes"]["all-to-all"], t["counts"]["all-to-all"]) == (4 * per, 4)


def test_rule_5_gnn_gathers_node_states_each_layer():
    cfg = get_config("graphsage-reddit", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"))
    shape = ShapeSpec("molecule", "train", (("n_nodes", 15), ("n_edges", 32),
                                            ("batch", 4), ("d_feat", 8)))
    cell = I._gnn_cells("graphsage-reddit", cfg, shape, mesh)
    r = D.reckon(cell, D.measure(cell).records)
    nodes = 60 * cfg.d_hidden * 4  # [60, d] float32, whole, a layer
    assert (r["bytes"]["all-gather"], r["counts"]["all-gather"]) == \
        (cfg.n_layers * nodes, cfg.n_layers)
    grads = r["bytes"]["reduce-scatter"] - cfg.n_layers * nodes
    assert r["counts"]["reduce-scatter"] == cfg.n_layers and grads == 0
    assert r["counts"]["all-reduce"] == sum(1 for _ in
                                            cell.args[0].parameters())


def test_rule_6_sequence_sharded_decode_all_reduces_partials():
    # B = 1: partials [1, 2, 4 + 2] float32 = 48 B a layer, beside rule 3's
    # two [1, 1, 8] bf16 activations (16 B each, replicated batch)
    _, r = _tiny_lm("decode", b=1, s=16)
    assert (r["bytes"]["all-reduce"], r["counts"]["all-reduce"]) == (80, 3)


# -------------------------- kernels' meta routes -----------------------------


def test_flash_attention_meta_route_counts_work_and_launches_nothing():
    import sys as _sys

    from repro_torch.kernels.flash_attention.ops import attention

    fa = _sys.modules["repro_torch.kernels.flash_attention.flash_attention"]
    before = fa.launches
    for dt in (torch.bfloat16, torch.float32):
        q = torch.empty(2, 100, 4, 64, device="meta", dtype=dt)
        k = torch.empty(2, 100, 2, 64, device="meta", dtype=dt)
        with A.kernel_work() as w:
            o = attention(q, k, k, causal=True, use_kernel=True)
        assert o.shape == q.shape and o.dtype == dt and o.device.type == "meta"
        assert o.stride() == q.stride()  # the model layout, as the kernel's
        nb, fl = A.attention_work(2, 4, 2, 100, 100, 64, True, q.element_size())
        assert (w["flops"], w["bytes"], dict(w["calls"])) == \
            (fl, nb, {"flash_attention": 1})
    assert fa.launches == before
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(torch.empty(1, 1, 8, 24, device="meta"),
                           torch.empty(1, 1, 8, 24, device="meta"),
                           torch.empty(1, 1, 8, 24, device="meta"))
    # a CPU tensor takes the plain version and counts nothing
    with A.kernel_work() as w:
        attention(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 1, 16),
                  torch.randn(1, 8, 1, 16), use_kernel=True)
    assert w["flops"] == 0 and not w["calls"]


def test_router_swap_meta_route_counts_balanced_work():
    import sys as _sys

    from repro_torch.kernels.router_swap.ops import router_swap_padded_batched

    rs = _sys.modules["repro_torch.kernels.router_swap.router_swap"]
    before = rs.launches
    g, t, e = 3, 20, 4
    aff = torch.empty(g, t, e, device="meta")
    assign = torch.empty(g, t, dtype=torch.int64, device="meta")
    cur = torch.empty(g, t, device="meta")
    with A.kernel_work() as w:
        gain, partner = router_swap_padded_batched(aff, assign, cur)
    assert (gain.shape, gain.dtype, partner.shape, partner.dtype) == \
        ((g, t), torch.float32, (g, t), torch.int32)
    # 5 tokens an expert: 20 * 20 - 4 * 25 pairs on other experts a group
    assert w["flops"] == 3.0 * g * (t * t - e * 25)
    assert w["bytes"] == g * t * (4 * e + 8) + g * t * 8
    assert rs.launches == before
    assert A.balanced_counts(1, 10, 4).tolist() == [[3, 3, 2, 2]]
    real = torch.tensor([[0, 0, 1, 3]])
    assert A.swap_work(real, 4)[1] == 3.0 * (16 - 4 - 1 - 1)


def test_awpm_router_runs_on_meta_without_host_reads():
    from repro_torch.models import moe as M

    logits = torch.empty(2, 16, 4, device="meta")
    with A.kernel_work() as w:
        topi, slot, wts, keep, aux = M.awpm_route_batched(logits, 2, 4, 3)
    assert topi.shape == slot.shape == wts.shape == (2, 16, 2)
    assert dict(w["calls"]) == {"router_swap": 2 * 3}
    assert M.balanced_assign_batched(torch.empty(2, 8, 4, device="meta"),
                                     2).shape == (2, 8)


# ------------------------------ whole cells ----------------------------------


def _check(rec, mesh):
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == (512 if mesh == "multi" else 256)
    assert rec["flops_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["peak_memory_per_device"] == rec["argument_bytes"] + \
        rec["temp_bytes"]


@pytest.mark.parametrize("arch, shape, mesh", [
    ("qwen2-0.5b", "train_4k", "single"), ("qwen2-0.5b", "prefill_32k", "multi"),
    ("graphsage-reddit", "molecule", "single")])
def test_run_cell_on_the_jax_slow_test_cells(arch, shape, mesh):
    _check(D.run_cell(arch, shape, mesh), mesh)


def test_run_cell_on_the_matching_cell_traces_one_rank():
    recs = _port_child("""
from repro_torch.launch import dryrun as D
OUT["rec"] = D.run_cell("awpm-matching", "match_4m", "multi")
""")
    rec = recs["rec"]
    _check(rec, "multi")
    coll = rec["collectives"]
    # one AWAC round: two bucketed all-to-alls of three payloads and their
    # validity each, the winners' gathers, the dropped-count all-reduce
    assert coll["counts"]["all-to-all"] == 8
    assert coll["counts"]["all-gather"] == 8
    assert coll["counts"]["all-reduce"] == 1
    assert coll["total"] == sum(coll["bytes"].values()) > 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_cell_of_an_arch_at_both_meshes(arch):
    if arch == "awpm-matching":
        recs = _port_child("""
from repro_torch.launch import dryrun as D
OUT["recs"] = [D.run_cell("awpm-matching", s, mk)
               for s in ("match_4m", "match_16m")
               for mk in ("single", "multi")]
""")["recs"]
        for rec in recs:
            _check(rec, rec["mesh"])
        return
    traces = {}
    for s in shapes_for(get_config(arch)):
        single = D.run_cell(arch, s.name, "single", traces=traces)
        multi = D.run_cell(arch, s.name, "multi", traces=traces)
        _check(single, "single")
        _check(multi, "multi")
        if get_config(arch).family == "lm":
            # one trace for both meshes: the same totals over 2x the chips
            assert single["flops_per_device"] == 2 * multi["flops_per_device"]
            assert single["model_flops_ratio"] == multi["model_flops_ratio"]


def test_main_writes_records_and_the_report_reads_them(tmp_path, monkeypatch,
                                                       capsys):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    monkeypatch.setattr(report, "RESULTS", tmp_path)
    with pytest.raises(SystemExit) as ex:
        D.main(["--arch", "bert4rec", "--mesh", "both", "--keep-hlo"])
    assert ex.value.code == 0
    assert len(list(tmp_path.glob("bert4rec__*.json"))) == 8
    assert (tmp_path / "bert4rec__serve_p99__single.ops.txt").read_text()
    capsys.readouterr()
    report.main(["--table", "summary", "--mesh", "multi"])
    assert capsys.readouterr().out.strip() == "multi: 4/4 cells OK"
    with pytest.raises(SystemExit):
        D.main(["--arch", "bert4rec", "--shape", "serve_p99",
                "--skip-existing"])
    assert "[skip]" in capsys.readouterr().out


# --------------------------------- the card ----------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an NVIDIA H100): the 1x1 card "
                    "check runs the kernels")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(6))
def test_card_counts_what_meta_counts(cuda, i):
    cell = _smoke_cells("cuda")[i]
    meta = D.measure(cell)
    args = I.materialize(cell, cuda, seed=0)
    cell.fn(*args)  # warm-up: cuBLAS's workspaces stay beside the arguments
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card = D.measure(cell, args=args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert meta.flops == card.flops
    assert abs(meta.temp_bytes - peak) <= 0.1 * peak + 2**20


@pytest.mark.gpu
def test_card_prefill_launches_the_kernel_once_a_layer(cuda):
    from repro_torch.kernels import backend

    cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              attention_impl="cuda", dtype="bfloat16")
    cell = I._lm_cells("qwen2-0.5b", cfg, ShapeSpec(
        "prefill", "prefill", (("seq_len", 64), ("global_batch", 2))), MESH1)
    args = I.materialize(cell, cuda, seed=0)
    backend.reset_launch_counts()
    card = D.measure(cell, args=args)
    assert backend.launch_counts()["flash_attention"] == cfg.n_layers
    assert card.kernel_calls == {"flash_attention": cfg.n_layers}
    assert D.measure(cell).flops == card.flops
