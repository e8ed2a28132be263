"""The port's examples (``repro_torch.examples``) at a small size on the CPU,
against the JAX package where they compute something it computes.

``quickstart``: the three AG+GEMM paths against the reference's
``compile_overlap("ag_matmul")`` under ``shard_map`` on the same numpy
inputs (1e-5 of max, float32 summation order), and its transport counts
(ring permutes against one gather).  ``moe_overlap_demo``: its dense
oracle against the reference example's oracle written in jnp on the same
inputs (1e-5 of max), and its double ring within the demo's own 1e-4.
``serve_lm`` / ``train_lm``: the CLIs they drive, reduced, on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.examples import moe_overlap_demo, quickstart, serve_lm, train_lm
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

SMALL = ["--device", "cpu", "--world", "4"]


def test_quickstart_against_the_reference():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.backend import make_mesh, shard_map
    from repro.core import BlockChannel, CommSpec, compile_overlap

    out = quickstart.main(SMALL + ["--tokens", "64", "--hidden", "32", "--ffn", "48", "--channels", "2"])
    assert max(out["max_abs_err"].values()) <= quickstart.ATOL
    counts = out["counts"]
    assert set(counts["tilelink"]) == {"permute"} and set(counts["non-overlap"]) == {"all_gather"}
    assert counts["fused kernel"] == {}
    rng = np.random.default_rng(0)  # the example's own draws
    x = rng.standard_normal((64, 32), dtype=np.float32)
    w = rng.standard_normal((32, 48), dtype=np.float32)
    mesh = make_mesh((4,), ("model",))
    fn = compile_overlap("ag_matmul", BlockChannel(axis="model", num_channels=2, comm=CommSpec(order="ring")))
    sm = shard_map(fn, mesh, in_specs=(P("model", None), P(None, "model")), out_specs=P(None, "model"))
    want = np.asarray(jax.jit(sm)(jnp.asarray(x), jnp.asarray(w)))  # [S, FF]
    for name, y in out["outputs"].items():
        got = torch.cat(list(y.unbind(0)), dim=-1).numpy()  # rank r's columns
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name


def test_moe_demo_against_the_reference_oracle():
    import jax
    import jax.numpy as jnp

    args = SMALL + ["--experts", "8", "--top-k", "2", "--tokens", "64", "--d-model", "16", "--d-expert", "32"]
    out = moe_overlap_demo.main(args)
    assert out["max_abs_err"] <= moe_overlap_demo.ATOL and out["grouped_launches"] == 0  # plain versions here
    rng = np.random.default_rng(1)
    e, k, d, f, tok = 8, 2, 16, 32, 64
    x, wr = rng.standard_normal((tok, d), dtype=np.float32) * 0.5, rng.standard_normal((d, e), dtype=np.float32)
    wgu = rng.standard_normal((e, d, 2 * f), dtype=np.float32) * 0.1
    wdn = rng.standard_normal((e, f, d), dtype=np.float32) * 0.1
    # the reference example's dense oracle (examples/moe_overlap_demo.py), in jnp
    probs = jax.nn.softmax(x @ wr, -1)
    topw, topi = jax.lax.top_k(probs, k)
    topw = topw / topw.sum(-1, keepdims=True)
    dense = jnp.zeros_like(x)
    for ei in range(e):
        h = x @ wgu[ei]
        dense += ((topi == ei) * topw).sum(-1)[:, None] * ((jax.nn.silu(h[:, :f]) * h[:, f:]) @ wdn[ei])
    got = moe_overlap_demo.dense_oracle(*(torch.from_numpy(a) for a in (x, wr, wgu, wdn)), k).numpy()
    assert np.abs(got - np.asarray(dense)).max() <= 1e-5 * np.abs(np.asarray(dense)).max()


def test_serve_lm_runs_on_the_cpu(capsys):
    serve_lm.main(["--device", "cpu", "--dtype", "f32", "--prompt-len", "8", "--new-tokens", "4", "--batch", "2"])
    assert "tokens/s" in capsys.readouterr().out


def test_train_lm_runs_on_the_cpu():
    out = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"])
    losses = [r["loss"] for r in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
