"""The port's checkpoints, resilience runtime and train CLI, on the CPU.

``CheckpointManager`` (async, atomic, keep-K) on reduced smollm-360m (2
layers, W = 4, float32 and bfloat16): the roundtrip and retention, a resumed
run equal to the uninterrupted one bitwise, bf16 leaves bitwise (stored as
their int16 view), a checkpoint saved at W = 4 restored at W = 2 (logits
within 1e-5 of max: the two worlds split the GEMMs differently); the
resume and the W = 4 -> W = 2 restore also for reduced granite-moe-3b-a800m
and deepseek-moe-16b; and
``convert.unshard_params`` against the JAX package's global layout (every
ported layer kind, exactly).  ``StepWatchdog``, ``run_resilient`` and
``ElasticMesh.plan`` as the reference's tests drive them; the train CLI for
a few steps on the CPU, then resumed from its checkpoint (smollm-360m, and
granite-moe-3b-a800m against its uninterrupted run).
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro.runtime import ElasticMesh as JElasticMesh
from repro_torch.backend.mesh import World
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import from_jax_params, shard_params, unshard_params
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.parallel.context import ParallelContext
from repro_torch.runtime import ElasticMesh, StepWatchdog, run_resilient
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.training.optimizer import tree_leaves, tree_map
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)
from utils import reduce_config as j_reduce_config

pytestmark = pytest.mark.usefixtures("torch_threads")

TP = 4
ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-2.7b", "qwen2-72b", "gemma3-27b")
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-moe-16b")


def _cfg(n_layers=2, vocab=128):
    return dataclasses.replace(reduce_config(get_config("smollm-360m")), n_layers=n_layers, vocab_size=vocab)


def _moe_cfg(arch):
    return dataclasses.replace(reduce_config(get_config(arch)), vocab_size=128)


def _state(cfg, world, dtype=torch.float32, seed=0):
    params = lm.init(cfg, world, torch.Generator().manual_seed(seed), dtype)
    return params, init_opt_state(lm.trainable(params, cfg))


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)  # fmt: skip


@pytest.mark.parametrize("logical", [True, False])
def test_checkpoint_roundtrip_and_retention(tmp_path, logical):
    cfg, world = _cfg(), World(TP, "cpu")
    params, opt = _state(cfg, world)
    opt["mu"] = tree_map(lambda t: t + 1.5, opt["mu"])
    layout = dict(cfg=cfg, world=world) if logical else {}
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3):
        mgr.save(s, params, opt, extra={"data": {"cursor": s * 10, "seed": 0}}, **layout)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3  # retention dropped step 1
    restored, meta = mgr.restore(3, {"params": params, "opt": opt}, **layout)
    assert meta["extra"]["data"]["cursor"] == 30 and meta["step"] == 3
    _equal_trees(restored, {"params": params, "opt": opt})
    assert not any(n.startswith(".tmp") for n in (p.name for p in tmp_path.iterdir()))  # renamed into place


def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    """Every bf16 bit pattern survives (stored as int16, not widened), NaN payloads included."""
    cfg, world = _cfg(), World(TP, "cpu")
    params, opt = _state(cfg, world, torch.bfloat16)
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    params["final_ln"] = bits[: cfg.d_model].view(torch.bfloat16).clone()
    params["layers"][0]["mixer"]["wqkv"] = (
        bits.repeat(-(-params["layers"][0]["mixer"]["wqkv"].numel() // bits.numel()))[
            : params["layers"][0]["mixer"]["wqkv"].numel()].view(torch.bfloat16).reshape(
            params["layers"][0]["mixer"]["wqkv"].shape)
    )  # fmt: skip
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, params, opt, cfg=cfg, world=world)
    restored, meta = mgr.restore(1, {"params": params, "opt": opt}, cfg=cfg, world=world)
    assert "torch.bfloat16" in meta["dtypes"]
    _equal_trees(restored["params"], params)


def test_restore_checks_the_tree(tmp_path):
    cfg, world = _cfg(), World(TP, "cpu")
    params, opt = _state(cfg, world)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, params, opt, cfg=cfg, world=world)
    p16, o16 = _state(cfg, world, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.restore(1, {"params": p16, "opt": o16}, cfg=cfg, world=world)
    with pytest.raises(ValueError, match="cfg and world"):
        mgr.restore(1, {"params": params, "opt": opt})


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_resume_continues_training_bitwise(tmp_path, backend):
    """Save at step 2, restore, continue: bitwise the uninterrupted run (4 steps)."""
    _resume_bitwise(tmp_path, _cfg(), backend)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_resume_continues_training_bitwise(tmp_path, arch):
    """As above for a reduced MoE model on the fused backend: the float32
    router, the experts' w_gu / w_down (sharded by experts, not packed) and
    deepseek's shared and dense MLPs, parameters and moments."""
    _resume_bitwise(tmp_path, _moe_cfg(arch), "fused")


def _resume_bitwise(tmp_path, cfg, backend):
    world = World(TP, "cpu")
    pc = ParallelContext(world=world, backend=backend)
    step = make_train_step(lm, cfg, pc, AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=2),
                           grad_masks=lm.grad_masks(cfg, pc))  # fmt: skip
    params, opt = _state(cfg, world)
    pipe_u = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    p_u, o_u, losses_u = params, opt, []
    for _ in range(4):
        p_u, o_u, m = step(p_u, o_u, pipe_u.host_batch())
        losses_u.append(m["loss"])

    pipe = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    p, o = params, opt
    for _ in range(2):
        p, o, _ = step(p, o, pipe.host_batch())
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, p, o, extra={"data": pipe.state()}, cfg=cfg, world=world)
    mgr.wait()
    fresh, fresh_opt = _state(cfg, world, seed=5)  # "crash": the restore lands on other values
    restored, meta = mgr.restore(2, {"params": fresh, "opt": fresh_opt}, cfg=cfg, world=world)
    p2, o2 = restored["params"], restored["opt"]
    pipe2 = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    pipe2.restore(meta["extra"]["data"])
    losses = []
    for _ in range(2):
        p2, o2, m = step(p2, o2, pipe2.host_batch())
        losses.append(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_u[2:]))
    _equal_trees(p2, p_u)
    _equal_trees(o2, o_u)


def test_restore_onto_another_world_size(tmp_path):
    """Saved at W = 4, restored at W = 2: the same model (each rank's packed
    [K || V] and [gate || up] columns re-packed for W = 2), equal logits.
    The global layout itself would not do: those columns mean other heads
    and units at W = 2."""
    _restore_w4_at_w2(tmp_path, _cfg())


def test_restore_onto_another_world_size_qwen2_bias(tmp_path):
    """As above for reduced qwen2-72b, whose QKV bias (seeded non-zero) is
    packed per rank like ``wqkv``: its [K || V] halves round-trip too."""
    cfg = dataclasses.replace(reduce_config(get_config("qwen2-72b")), n_layers=2, vocab_size=128)
    _restore_w4_at_w2(tmp_path, cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_restore_onto_another_world_size(tmp_path, arch):
    """A reduced MoE model saved at W = 4, restored at W = 2: its 8 experts
    pad to 8 at both (E_loc 2 and 4), so the expert rows re-shard as they
    are; equal logits."""
    _restore_w4_at_w2(tmp_path, _moe_cfg(arch))


def _restore_w4_at_w2(tmp_path, cfg, packed=None, rtol=1e-5):
    """Save ``cfg`` at W = 4, restore at W = 2: the first layer's ``packed``
    leaves (default: the kv columns and bias) differ in the global layout,
    the logits agree to ``rtol`` of their max.  Returns (params, restored)."""
    w4, w2 = World(4, "cpu"), World(2, "cpu")
    params, opt = _state(cfg, w4)
    gen = torch.Generator().manual_seed(9)
    for layer in params["layers"]:  # a zero bias would round-trip whatever the packing
        if "bqkv" in layer.get("mixer", {}):
            layer["mixer"]["bqkv"] = torch.randn(layer["mixer"]["bqkv"].shape, generator=gen)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, params, opt, cfg=cfg, world=w4)
    like, like_opt = _state(cfg, w2, seed=1)
    restored, _ = mgr.restore(1, {"params": like, "opt": like_opt}, cfg=cfg, world=w2)
    glob, glob4 = unshard_params(restored["params"], cfg, w2), unshard_params(params, cfg, w4)
    for name in packed or (("wkv", "bkv") if cfg.qkv_bias else ("wkv",)):
        assert not torch.equal(glob["layers"][0]["mixer"][name], glob4["layers"][0]["mixer"][name])
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16)))
    lg4, _ = lm.forward(params, cfg, ParallelContext(world=w4, backend="eager"), toks)
    lg2, _ = lm.forward(restored["params"], cfg, ParallelContext(world=w2, backend="eager"), toks)
    assert (lg4 - lg2).abs().max().item() <= rtol * lg4.abs().max().item()
    return params, restored


@pytest.mark.parametrize("arch", ARCHS)
def test_unshard_params_is_the_reference_layout(arch, pc8):
    """unshard_params(from_jax_params(p)) is the JAX package's global tree
    (layers unstacked), exactly; shard_params inverts it."""
    jcfg = dataclasses.replace(j_reduce_config(j_get_config(arch)), vocab_size=130)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), vocab_size=130)
    np_params = jax.tree_util.tree_map(np.asarray, jlm.init(jax.random.PRNGKey(0), jcfg, pc8, jnp.float32))
    world = World(TP, "cpu")
    params = from_jax_params(np_params, cfg, world)
    glob = unshard_params(params, cfg, world)
    ref_layers = list(np_params["prefix"])
    for u in range(np_params["scan"][0]["mixer"]["ln"].shape[0]):
        ref_layers += [jax.tree_util.tree_map(lambda a: a[u], unit) for unit in np_params["scan"]]
    ref = {"embed": np_params["embed"], "final_ln": np_params["final_ln"], "layers": ref_layers}
    if "lm_head" in np_params:
        ref["lm_head"] = np_params["lm_head"]
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, glob))
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(glob)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.numpy())
    _equal_trees(shard_params(glob, cfg, world), params)


@pytest.mark.parametrize("n", [512, 256, 240, 6, 4, 1])
def test_elastic_plan_matches_reference(n):
    assert ElasticMesh(target_model=16).plan(n) == JElasticMesh(target_model=16).plan(n)
    assert ElasticMesh(target_model=4).world(n, "cpu").size == JElasticMesh(target_model=4).plan(n)["model"]


def test_run_resilient_restarts_after_failures():
    calls = {"n": 0}

    def run(state):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(f"simulated node failure {calls['n']}")
        return "done"

    failures = []
    out = run_resilient(lambda: {"attempt": calls["n"]}, run, max_failures=3,
                        on_failure=lambda e, n: failures.append(str(e)))  # fmt: skip
    assert out == "done" and len(failures) == 2
    calls["n"] = -10
    with pytest.raises(RuntimeError):
        run_resilient(dict, run, max_failures=2)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold=3.0, min_samples=3)
    for _ in range(5):
        wd.start()
        time.sleep(0.01)
        assert wd.stop() is False
    wd.start()
    time.sleep(0.2)
    assert wd.stop() is True
    assert wd.stragglers == 1 and wd.median() > 0


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --reduce``: 3 steps
    with checkpoints, then 4 resumed from the last one (one more step)."""
    args = ["--arch", "smollm-360m", "--reduce", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]  # fmt: skip
    out = train_cli.main(args + ["--steps", "3"])
    assert len(out["history"]) == 3 and all(np.isfinite(r["loss"]) for r in out["history"])
    assert out["params"]["embed"].dtype == torch.float32  # f32 is the CPU's default dtype
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    again = train_cli.main(args + ["--steps", "4"])
    assert [r["step"] for r in again["history"]] == [3]
    assert "resumed from step 3" in capsys.readouterr().out
    assert set(again["history"][0]["launches"]) >= {"ag_gemm", "gemm_rs", "flash_attention", "matmul"}


def test_train_cli_runs_and_resumes_a_moe_model_on_the_cpu(tmp_path, capsys):
    """``--arch granite-moe-3b-a800m --reduce --device cpu``: 2 steps with a
    checkpoint, then one more resumed; the resumed step equals the
    uninterrupted run's third step bitwise."""
    args = ["--arch", "granite-moe-3b-a800m", "--reduce", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1"]  # fmt: skip
    whole = train_cli.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path / "whole")])
    assert len(whole["history"]) == 3 and all(np.isfinite(r["loss"]) for r in whole["history"])
    train_cli.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path / "cut")])
    again = train_cli.main(args + ["--steps", "3", "--ckpt-dir", str(tmp_path / "cut")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in again["history"]] == [2] and again["history"][0]["loss"] == whole["history"][2]["loss"]
    _equal_trees(again["params"], whole["params"])
    assert set(again["history"][0]["launches"]) >= {"grouped_matmul", "ag_gemm", "gemm_rs"}


def test_train_entry_point_needs_the_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.train("smollm-360m", reduce=True, steps=1)
