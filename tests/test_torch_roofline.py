"""The port's roofline arithmetic (``roofline.analysis``) against the JAX
package's, on the CPU: ``useful_flops`` of every arch of the registry,
full and reduced, on every shape cell of ``shapes_for``, and
``roofline_terms`` given JAX's own ``V5E`` table (passed in from the
child, since the port keeps no TPU constant), equal exactly. The port's
``H100`` table holds the card's rates.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.configs import ALL_ARCHS, get_config, shapes_for  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    H100,
    Roofline,
    roofline_terms,
    useful_flops,
)
from test_torch_harness import run_reference  # noqa: E402

# (flops, bytes, collective bytes) per device: each term dominant once,
# a tie, and zeros
TERMS = ((1e15, 1e9, 1e6), (1e9, 1e13, 1e6), (1e9, 1e6, 1e12),
         (197e12, 819e9, 50e9), (0.0, 0.0, 0.0), (3.7e13, 2.9e11, 4.1e9))

REFERENCE = """
import json

from repro.configs import ALL_ARCHS, get_config, shapes_for
from repro.roofline.analysis import V5E, roofline_terms, useful_flops

flops = {}
for arch in ALL_ARCHS:
    for red in (False, True):
        cfg = get_config(arch, reduced=red)
        for shape in shapes_for(cfg):
            flops[f"{arch}@{red}@{shape.name}"] = useful_flops(
                arch, shape.name, shape.mode, cfg, shape)
OUT["flops"] = json.dumps(flops)
OUT["v5e"] = json.dumps(V5E)
OUT["terms"] = json.dumps([roofline_terms(*t).to_dict()
                           for t in json.loads(str(IN["terms"]))])
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE, {"terms": np.array(json.dumps(TERMS))},
                         tmp_path_factory.mktemp("roofline"))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_useful_flops_equal_jax(ref, arch, reduced):
    want = json.loads(str(ref["flops"]))
    cfg = get_config(arch, reduced=reduced)
    cells = shapes_for(cfg)
    assert cells
    for shape in cells:
        got = useful_flops(arch, shape.name, shape.mode, cfg, shape)
        assert got == want[f"{arch}@{reduced}@{shape.name}"], shape.name
        assert got > 0


def test_roofline_terms_equal_jax_with_its_table(ref):
    v5e = json.loads(str(ref["v5e"]))
    for t, want in zip(TERMS, json.loads(str(ref["terms"]))):
        got = roofline_terms(*t, hw=v5e)
        assert isinstance(got, Roofline)
        assert got.to_dict() == want, t


def test_h100_table_and_dominant_term():
    assert H100["peak_flops"] == 989e12 and H100["hbm_bw"] == 3.35e12
    assert H100["ici_bw"] == 450e9 and H100["smem_bytes"] == 227 * 1024
    assert H100["peak_flops_f32"] == 67e12
    r = roofline_terms(989e12, 3.35e12, 0.0)
    assert r.compute_s == 1.0 and r.memory_s == 1.0 and r.collective_s == 0
    assert r.dominant == "compute"  # a tie goes to the first term
    assert roofline_terms(1.0, 1e13, 1e9).dominant == "memory"
    assert roofline_terms(1.0, 1.0, 1e12).dominant == "collective"


def test_prefill_flops_of_the_served_models():
    """The model FLOPs ``chip_smoke.py``'s ``[dense_lm]`` reckons its
    share of the bf16 peak with: a prefill of 4 x 2,048 tokens."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec

    cell = ShapeSpec("prefill_2k", "prefill",
                     (("seq_len", 2048), ("global_batch", 4)))
    big = dataclasses.replace(get_config("qwen1.5-110b"), n_layers=6)
    for cfg, want in ((get_config("qwen2-7b"), 1.158e14), (big, 1.540e14)):
        got = useful_flops(cfg.name, cell.name, "prefill", cfg, cell)
        assert abs(got / want - 1) < 5e-4, (cfg.name, got)
