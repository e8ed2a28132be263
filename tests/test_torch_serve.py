"""The port's serve entry point against per-token JAX greedy decoding, and the
device policy of the port's entry points on a host without CUDA."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.parallel.sharding import place
from repro_torch.backend import World, resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params
from repro_torch.core.compiler import compile_overlap
from repro_torch.launch import serve
from repro_torch.parallel.context import ParallelContext
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

B, S0, NEW = 2, 16, 6


def _jax_greedy(cfg, pc, params, prompts, n_new, max_len):
    """JAX reference: prefill, then per-token decode_step + argmax."""
    lg, caches = jax.jit(lambda p, t: jlm.prefill(p, cfg, pc, t, max_len=max_len))(params, jnp.asarray(prompts))
    tok = np.asarray(jnp.argmax(lg[:, -1], -1))
    out = [tok]
    step = jax.jit(lambda p, c, t, n: jlm.decode_step(p, c, cfg, pc, t, n))
    for i in range(n_new - 1):
        lg, caches = step(params, caches, jnp.asarray(tok[:, None].astype(np.int32)), S0 + i)
        tok = np.asarray(jnp.argmax(lg[:, 0], -1))
        out.append(tok)
    return np.stack(out, axis=1)


ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "deepseek-moe-16b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_greedy_matches_jax_per_token_reference(pc8, mesh8, backend, arch):
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=128)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=128)
    jparams = place(jlm.init(jax.random.PRNGKey(3), jcfg, pc8, jnp.float32), mesh8, jlm.specs(jcfg, pc8))
    prompts = serve.make_prompts(cfg.vocab_size, B, S0, seed=5)
    ref = _jax_greedy(jcfg, pc8, jparams, prompts.astype(np.int32), NEW, S0 + NEW)
    world = World(4, "cpu")
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg, world)
    pc = ParallelContext(world=world, backend=backend)
    tokens, timings = serve.greedy(params, cfg, pc, torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(tokens.numpy(), ref)
    assert timings["decode_steps"] == NEW - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(capsys, arch):
    r = serve.main(["--arch", arch, "--reduce", "--device", "cpu", "--dtype", "f32",
                    "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"])  # fmt: skip
    assert r["tokens"].shape == (2, 3) and r["backend"] == "eager" and r["device"] == "cpu"
    assert "tokens/s" in capsys.readouterr().out


def test_seeded_serve_is_reproducible():
    kw = dict(batch=2, prompt_len=8, new_tokens=3, dtype="f32", device="cpu", reduce=True)
    a, b = serve.serve("smollm-360m", **kw), serve.serve("smollm-360m", **kw)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_entry_points_raise_without_cuda():
    """With no CUDA device and no explicit device='cpu', nothing runs quietly
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the policy under test is the CUDA-less one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        World(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve("smollm-360m", reduce=True, batch=1, prompt_len=8, new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-360m", "--reduce"])
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_context_backend_policy():
    world = World(4, "cpu")
    assert ParallelContext(world=world).backend == "eager"
    assert ParallelContext(world=world, backend="fused").fused
    # mode="baseline" on the fused backend: attention and the head keep the kernels (pc.fused), every
    # collective op compiles on "eager" without overlap (compile_overlap itself still refuses fused)
    pc = ParallelContext(world=world, backend="fused", mode="baseline")
    assert pc.fused and ParallelContext(world=world, mode="baseline").backend == "eager"
    with pytest.raises(NotImplementedError):
        compile_overlap("ag_matmul", pc.channel, world=world, backend="fused", overlapped=False)
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 2, 8, 16, generator=gen), torch.randn(4, 16, 24, generator=gen)
    for kind, args in (("ag_matmul", (x, w)), ("matmul_rs", (x, w[..., :12]))):
        base = compile_overlap(kind, pc.channel, world=world, backend="eager", overlapped=False)
        assert torch.equal(getattr(pc, kind)(*args), base(*args))
    with pytest.raises(ValueError):
        ParallelContext(world=world, backend="pallas")
    with pytest.raises(ValueError):
        World(0, "cpu")
