"""``ggad_tpu_torch.entry`` against the root ``__graft_entry__.py``:
``entry()``'s eval forward from JAX's weights equals JAX's
(1e-5·(1 + |JAX|)), and ``dryrun_multichip`` passes every assertion of
its legs on a local mesh of 4 shards on the CPU."""

import os
import sys

import jax
import numpy as np

from ggad_tpu_torch.entry import dryrun_multichip, entry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__ as ge  # noqa: E402


def test_entry_forward_matches_jax():
    jfn, jargs = ge.entry()
    expect = np.asarray(jfn(*jargs))
    fn, args = entry(initial_params=jax.tree.map(np.asarray, jargs[0]),
                     device="cpu")
    got = fn(*args).numpy()
    assert got.shape == expect.shape == (512, 1)
    assert np.all(np.abs(got - expect) <= 1e-5 * (1 + np.abs(expect)))
    fn, args = entry(device="cpu")         # the port's seeded init
    assert np.all(np.isfinite(fn(*args).numpy()))


def test_dryrun_multichip_passes_on_the_cpu():
    out = dryrun_multichip(4, device="cpu")
    assert {"gspmd", "halo dense", "halo ring", "halo sched",
            "halo bcsr sched", "halo ell", "2-D tp",
            "dp minibatch"} <= set(out)
    assert out["halo bcsr sched"]["route"] == "bcsr"
    assert out["halo ell"]["route"] == "ell"
    assert out["halo dense"]["route"] == "coo"
    # plain versions on the CPU: no kernel launch is counted
    assert all(leg["k1"] == leg["k2"] == 0 for k, leg in out.items()
               if k.startswith("halo"))
