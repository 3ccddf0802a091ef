"""The port's attention core against the JAX fused kernel (interpret mode)
and the XLA core; plus the CPU-side contract of the CUDA wrappers.

The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
the wrappers must take their plain versions for CPU tensors, never count a
launch, and build nothing at import.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.ops.pallas_attention import (attention_core_xla,
                                                     fused_attention_core)
from imagecaptioner_tpu_torch.ops import attention as A
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.ops import lstm_scan as S

ATOL = 1e-5  # float32 on both sides, different summation order


def _qkv(B, H, Lq, Lk, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D))]


@pytest.mark.parametrize("B,H,Lq,Lk,D,causal", [
    (2, 4, 9, 9, 64, False),
    (2, 4, 9, 9, 64, True),
    (1, 2, 5, 13, 16, False),
    (2, 3, 17, 17, 8, True),
])
def test_attention_core_plain_matches_jax(B, H, Lq, Lk, D, causal):
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=Lq + Lk)
    scale = 1.0 / np.sqrt(D)
    got = A.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal, scale=scale)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    fused = fused_attention_core(jq, jk, jv, causal, float(scale), True)
    xla = attention_core_xla(jq, jk, jv, causal=causal, scale=float(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL, rtol=0)


@pytest.mark.parametrize("q_dt,k_dt,v_dt", [
    ("float32", "float32", "bfloat16"),
    ("bfloat16", "float32", "float32"),
    ("bfloat16", "bfloat16", "bfloat16"),
])
def test_attention_core_mixed_dtype_contract(q_dt, k_dt, v_dt):
    """q and k promote to their result type; the output has v's dtype."""
    q, k, v = _qkv(2, 2, 7, 7, 16, seed=3)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    got = A.attention_core(torch.from_numpy(q).to(tdt[q_dt]),
                           torch.from_numpy(k).to(tdt[k_dt]),
                           torch.from_numpy(v).to(tdt[v_dt]),
                           causal=True, scale=0.25)
    ref = attention_core_xla(jnp.asarray(q, q_dt), jnp.asarray(k, k_dt),
                             jnp.asarray(v, v_dt), causal=True, scale=0.25)
    assert got.dtype == tdt[v_dt] and str(ref.dtype) == v_dt
    # bf16 outputs may differ by one bf16 rounding step (2**-8 relative)
    atol = ATOL if v_dt == "float32" and q_dt == k_dt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("Lq,Lk,causal", [(9, 9, False), (9, 9, True),
                                          (5, 13, False)])
def test_attention_gradients_match_jax(Lq, Lk, causal):
    """The backward the CUDA forward is given under autograd (recompute the
    plain core, differentiate it) against ``jax.grad`` through
    ``fused_attention_core`` in interpret mode, and against ordinary
    autograd through the plain core."""
    q, k, v = _qkv(2, 3, Lq, Lk, 16, seed=11 + Lq)
    g = np.random.default_rng(5).standard_normal((2, 3, Lq, 16)
                                                 ).astype(np.float32)
    ref = jax.grad(lambda q_, k_, v_: jnp.sum(
        fused_attention_core(q_, k_, v_, causal, 0.25, True) * g),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = A.attention_core_grads(tq, tk, tv, torch.from_numpy(g),
                                 causal=causal, scale=0.25)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (A.attention_core(*leaves, causal=causal, scale=0.25)
     * torch.from_numpy(g)).sum().backward()
    for gi, ri, leaf in zip(got, ref, leaves):
        np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(gi.numpy(), leaf.grad.numpy(), atol=1e-6,
                                   rtol=0)
    only_v = A.attention_core_grads(tq, tk, tv, torch.from_numpy(g),
                                    causal=causal, scale=0.25,
                                    needs=(False, False, True))
    assert only_v[0] is None and only_v[1] is None
    np.testing.assert_array_equal(only_v[2].numpy(), got[2].numpy())


def test_cpu_tensors_never_launch_kernels():
    A.launches = G.launches = 0
    S.launches_eval = S.launches_train = S.launches_bwd = 0
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 49, 49, 64, seed=5))
    A.attention_core(q, k, v, scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_core_cuda(q, k, v, scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        G.greedy_decode_cuda({}, q[0], q[0])
    with pytest.raises(ValueError, match="CUDA"):
        S.decoder_scan_cuda(*[q[0, 0]] * 12)
    assert A.launches == 0 and G.launches == 0
    assert S.launches_eval == S.launches_train == S.launches_bwd == 0


def test_build_module_imports_without_nvcc():
    code = ("import os, shutil, sys\n"
            "os.environ['PATH'] = ''\n"
            "os.environ['CUDA_HOME'] = '/nonexistent'\n"
            "from imagecaptioner_tpu_torch.ops import (_build, attention, greedy,\n"
            "                                          lstm_scan)\n"
            "assert shutil.which('nvcc') is None\n"
            "assert set(_build.SOURCES) == {'attention_core', 'greedy_decode',\n"
            "    'decoder_scan', 'decoder_scan_bwd'}\n"
            "assert all((_build.CSRC / (s + '.cu')).is_file()"
            " for s in _build.SOURCES)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
