"""JAX's ``--spmm_impl`` names on the port (``ggad_tpu/cli.py:40-41``):
``xla`` runs as ``coo`` and ``pallas`` as ``bcsr``, with the same record;
``ops.spmm.spmm(impl="pallas")`` on a graph without tiles raises JAX's
``TypeError`` guidance (``ggad_tpu/ops/pallas_spmm.py:408-413``), and
``impl="xla"`` is the gather path."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggad_tpu.graph import from_scipy as jax_from_scipy
from ggad_tpu.ops.spmm import spmm as jax_spmm
from ggad_tpu_torch.cli import main as cli_main
from ggad_tpu_torch.datasets.synthetic import synthetic_gad
from ggad_tpu_torch.graph import from_scipy
from ggad_tpu_torch.ops.bcsr_spmm import as_bcsr_graph
from ggad_tpu_torch.ops.spmm import spmm


@pytest.mark.parametrize("alias,name", [("xla", "coo"), ("pallas", "bcsr")])
def test_cli_takes_jax_spmm_names(capsys, alias, name):
    argv = ["--dataset", "photo", "--synthetic_scale", "0.05",
            "--embedding_dim", "16", "--num_epoch", "2", "--eval_every",
            "2", "--device", "cpu", "--spmm_impl"]
    cli_main(argv + [alias])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli_main(argv + [name])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["spmm_route"] == ref["spmm_route"] == name
    assert (got["auc"], got["ap"]) == (ref["auc"], ref["ap"])


def test_spmm_pallas_on_a_plain_graph_raises_jax_guidance():
    ds = synthetic_gad(n_nodes=200, avg_degree=6, feat_dim=8, seed=1)
    g = from_scipy(ds.adj, device="cpu")
    x = torch.from_numpy(np.asarray(ds.features, np.float32))
    for impl in ("pallas", "bcsr"):
        with pytest.raises(TypeError, match="needs a BCSRGraph"):
            spmm(g, x, impl=impl)
    with pytest.raises(TypeError, match="needs a BCSRGraph"):
        jax_spmm(jax_from_scipy(ds.adj), jnp.asarray(ds.features),
                 impl="pallas")
    ref = spmm(g, x, impl="coo")
    torch.testing.assert_close(spmm(g, x, impl="xla"), ref)
    tiled = as_bcsr_graph(g, transpose=False)
    torch.testing.assert_close(spmm(tiled, x, impl="pallas"), ref,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(spmm(tiled, x, impl="xla"), ref)
    with pytest.raises(ValueError):
        spmm(g, x, impl="ell")
