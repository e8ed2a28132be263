"""The port's kernel modules on the CPU: plain versions against the JAX kernels.

On CPU tensors every kernel wrapper runs its plain PyTorch version; here
those are held against the JAX package's Pallas kernels in interpret mode
and its oracles in ``repro/kernels/ref.py``, on the same numpy-seeded
inputs.  The CUDA kernels themselves are checked on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: float32 atol 2e-4, rtol 2e-3 (as ``tests/test_kernels.py``);
bfloat16 2e-2 against the float32 oracle on the same bf16 inputs.
"""

import importlib
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.kernels import ref
from repro.nn.attention import chunked_attention as j_chunked
from repro_torch import kernels as tk
from repro_torch.kernels import build
from repro_torch.kernels.grouped_matmul import work_items
from repro_torch.nn.attention import chunked_attention
from test_torch_threads import torch_threads  # noqa: F401 (the fixture that pytestmark names)

pytestmark = pytest.mark.usefixtures("torch_threads")

F32 = dict(atol=2e-4, rtol=2e-3)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "causal,window,gqa,sq",
    [(False, None, 1, 96), (True, None, 2, 96), (True, 40, 2, 96), (False, 40, 1, 96), (True, None, 2, 32), (True, 24, 4, 48)],
)
def test_flash_plain_matches_reference(causal, window, gqa, sq):
    bh, sk, d = 4, 96, 16
    q, k, v = _rand(1, bh, sq, d), _rand(2, bh // gqa, sk, d), _rand(3, bh // gqa, sk, d)
    out = tk.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, window=window)
    oracle = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), **F32)


@pytest.mark.parametrize("causal,window,gqa", [(True, None, 2), (True, 40, 1)])
def test_flash_plain_matches_pallas_interpret(causal, window, gqa):
    bh, s, d = 2, 64, 16
    q, k, v = _rand(4, bh, s, d), _rand(5, bh // gqa, s, d), _rand(6, bh // gqa, s, d)
    out = tk.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, window=window)
    y = jk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window, bq=32, bk=32, interpret=True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(y), **F32)


def test_flash_plain_bf16_against_f32_oracle():
    q, k, v = (torch.from_numpy(_rand(s, 4, 64, 16)).bfloat16() for s in (7, 8, 9))
    out = tk.flash_attention(q, k[:2].contiguous(), v[:2].contiguous(), causal=True)
    assert out.dtype == torch.bfloat16
    oracle = ref.flash_attention_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k[:2], v[:2])), causal=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(oracle), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (24, 0), (None, 32)])
def test_chunked_attention_matches_reference(window, q_offset):
    b, h, hkv, sq, d = 2, 4, 2, 32, 16
    sk = sq + q_offset
    q, k, v = _rand(10, b, h, sq, d), _rand(11, b, hkv, sk, d), _rand(12, b, hkv, sk, d)
    out = chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, window=window, chunk=16, q_offset=q_offset
    )
    y = j_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window, chunk=16, q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(y), **F32)


@pytest.mark.parametrize("m,n,k", [(64, 48, 32), (50, 120, 37), (7, 960, 64)])
def test_matmul_plain_matches_reference(m, n, k):
    x, w = _rand(20, m, k), _rand(21, k, n)
    out = tk.matmul(torch.from_numpy(x), torch.from_numpy(w), tile=(64, 120, 32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.matmul_ref(jnp.asarray(x), jnp.asarray(w))), **F32)


def test_matmul_plain_matches_pallas_interpret_bf16():
    x, w = _rand(22, 128, 64), _rand(23, 64, 128)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    out = tk.matmul(xb, wb)
    y = jk.matmul(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(wb.float().numpy(), jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(y.astype(jnp.float32)), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize(
    "row_tiles,bm,n", [(40, 96, 1024), (3, 300, 200), (6, 8, 136), (1, 4, 264), (1, 1030, 72), (5, 64, 128)]
)
def test_gemm_work_items_store_every_output_once(row_tiles, bm, n):
    """The bf16 GEMM's items (grouped: row tiles of bm rows; plain: one row
    tile of M rows) store every output element exactly once, never past
    their row tile, numbered m-tile fastest (one weight strip at a time)."""
    items = work_items(row_tiles, bm, n)
    cover = np.zeros((row_tiles * bm, n), dtype=np.int32)
    for i, it in enumerate(items):
        assert it.index == i and 0 < it.rows <= 128 and it.row0 == it.t * bm + it.j * 128
        assert it.row0 + it.rows <= (it.t + 1) * bm
        cover[it.row0 : it.row0 + it.rows, it.nt * 128 : (it.nt + 1) * 128] += 1
    assert (cover == 1).all()
    assert [it.nt for it in items] == sorted(it.nt for it in items)


@pytest.mark.parametrize(
    "case,row_tiles,bm,n,count",
    [("smollm head, prefill", 1, 1024, 49152, 3072), ("smollm head, decode", 1, 4, 49152, 384),
     ("granite head, prefill", 1, 1024, 49160, 3080), ("mamba2 head, prefill", 1, 1024, 50280, 3144),
     ("granite gate|up", 40, 96, 1024, 320), ("granite down", 40, 96, 1536, 480),
     ("random 8-row tiles", 480, 8, 1536, 5760)],
)  # fmt: skip
def test_gemm_work_item_counts_at_serve_shapes(case, row_tiles, bm, n, count):
    """Item counts of the serve path's launches (the grid is min(items, 132)
    on the H100: one block of 129 KB shared memory per SM)."""
    assert len(work_items(row_tiles, bm, n)) == count, case


def test_kernel_modules_import_without_nvcc():
    """Importing builds nothing: the modules load on a host with no nvcc and
    no card, and only a launch on a CUDA tensor reaches the build."""
    for mod in ("matmul", "ag_gemm", "gemm_rs", "flash_attention", "grouped_matmul", "build"):
        importlib.import_module(f"repro_torch.kernels.{mod}")
    assert build._LIB is None
    assert sorted(build.CSRC.glob("*.cu")) and sorted(build.CSRC.glob("*.cuh"))
    if shutil.which("nvcc") is None and not (build.Path("/usr/local/cuda/bin/nvcc")).exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.features.nvcc()  # the probe moved to backend/features (build takes nvcc from it)


def test_ctypes_signatures_match_the_c_entry_points():
    """Every bound entry point exists in ``csrc/`` with as many parameters as
    its ctypes signature has (no compiler here checks the binding)."""
    text = "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))
    for name, sig in build._SIGNATURES.items():
        found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert found, name
        assert len(found.group(1).split(",")) == len(sig), name


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        tk.flash_attention(torch.zeros(3, 8, 16), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))
    with pytest.raises(ValueError):
        tk.flash_attention(torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), window=0)
    with pytest.raises(ValueError):
        tk.ag_gemm(torch.zeros(4, 8, 16), torch.zeros(4, 12, 8))
    with pytest.raises(ValueError):
        tk.gemm_rs(torch.zeros(4, 6, 16), torch.zeros(4, 16, 8))
    with pytest.raises(TypeError):
        build.dtype_code(torch.float16)


def test_launch_counters_exist_and_reset():
    tk.reset_launch_counts()
    assert tk.launch_counts() == {
        "matmul": 0, "ag_gemm": 0, "gemm_rs": 0, "flash_attention": 0, "grouped_matmul": 0, "ssd_intra_chunk": 0
    }  # fmt: skip
    tk.matmul(torch.ones(2, 3), torch.ones(3, 4))  # CPU: the plain version, no launch
    tk.grouped_matmul(torch.ones(4, 3), torch.ones(2, 3, 5), torch.zeros(2, dtype=torch.int32))
    tk.ssd_intra_chunk(torch.zeros(2, 4), torch.ones(2, 4, 4), torch.ones(2, 4, 3))
    assert tk.matmul.launches == 0 and tk.grouped_matmul.launches == 0 and tk.ssd_intra_chunk.launches == 0
