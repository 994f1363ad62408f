"""The port's flash attention (``kernels.ref.flash_attention_ref``,
``kernels.ops.flash_attention``, ``models.layers.blocked_attention``)
against the JAX package's three forms of it, on the CPU, in fp32.

Inputs come from numpy with a seed.  Tolerances: rtol = atol = 1e-5
against JAX's quadratic oracle (the same fp32 contractions in another
order), 2e-5 against the tiled forms (the Pallas kernel in interpret mode
and the jnp ``blocked_attention``), whose online softmax rescales partial
sums and, in ``blocked_attention``, scales q before the dot.  The CUDA
kernel itself runs only on the card (``tests/test_torch_on_card.py``,
``chip_smoke.py``); here the kernel mode must refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as TREF
from repro_torch.models import layers as TL

torch.set_num_threads(2)

ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)
TILED_TOL = dict(rtol=2e-5, atol=2e-5)
HEADS = [(4, 4), (4, 2), (8, 1)]


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_matches_jax_oracle_and_pallas_kernel(hq, hkv, window):
    """The port's plain version and its CPU dispatch against JAX's oracle
    (1e-5) and the Pallas kernel run in interpret mode with 32-row blocks
    (2e-5); S = 96 is a multiple of the Pallas block, as it requires."""
    q, k, v = _qkv(hq * 10 + hkv, 2, hq, hkv, 96, 32)
    want = np.asarray(JREF.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                               causal=True, window=window))
    pallas = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                     window=window, block_q=32, block_k=32,
                                     interpret=True))
    got_ref = TREF.flash_attention_ref(*_t(q, k, v), causal=True, window=window)
    got_ops = kops.flash_attention(*_t(q, k, v), causal=True, window=window, mode="auto")
    assert got_ops.dtype == torch.float32 and tuple(got_ops.shape) == q.shape
    np.testing.assert_array_equal(got_ops.numpy(), got_ref.numpy())
    np.testing.assert_allclose(got_ref.numpy(), want, **ORACLE_TOL)
    np.testing.assert_allclose(got_ref.numpy(), pallas, **TILED_TOL)


@pytest.mark.parametrize("softcap", [0.0, 3.0])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("hq,hkv", HEADS)
def test_blocked_attention_matches_jax_blocked_attention(hq, hkv, window, softcap):
    """models.layers.blocked_attention on (B, S, H, D) tensors with a
    ragged S (77, not a multiple of JAX's 32-row chunk), a window and a
    softcap, against JAX's jnp form (2e-5); the port's oracle with the same
    softcap agrees too."""
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _qkv(7, 2, hq, hkv, 77, 16))
    want = np.asarray(JL.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                           JModelConfig(attn_chunk=32), window=window,
                                           softcap=softcap))
    got = TL.blocked_attention(*_t(q, k, v), window=window, softcap=softcap)
    assert tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, **TILED_TOL)
    oracle = TREF.flash_attention_ref(*(t.transpose(1, 2) for t in _t(q, k, v)),
                                      window=window or None, softcap=softcap)
    np.testing.assert_allclose(oracle.transpose(1, 2).numpy(), want, **TILED_TOL)


def test_oracle_options_match_jax():
    """Non-causal attention and an explicit scale follow JAX's oracle;
    window None and 0 both mean full attention in the port."""
    q, k, v = _qkv(3, 1, 4, 2, 40, 8)
    for kw in (dict(causal=False), dict(causal=False, window=5), dict(scale=0.5)):
        want = np.asarray(JREF.flash_attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
        np.testing.assert_allclose(TREF.flash_attention_ref(*_t(q, k, v), **kw).numpy(),
                                   want, **ORACLE_TOL)
    full = TREF.flash_attention_ref(*_t(q, k, v))
    assert torch.equal(TREF.flash_attention_ref(*_t(q, k, v), window=0), full)


def test_bf16_plain_version_rounds_once():
    """In bf16 the plain version computes in fp32 and rounds its output
    once: it equals the fp32 result rounded to bf16."""
    q, k, v = _t(*_qkv(4, 1, 4, 2, 33, 16))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = TREF.flash_attention_ref(qb, kb, vb, window=8)
    want = TREF.flash_attention_ref(qb.float(), kb.float(), vb.float(), window=8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_kernel_mode_refuses_cpu_tensors():
    """The CUDA kernel has no CPU form: the wrapper and ``mode="kernel"``
    raise on CPU tensors and launch nothing."""
    q, k, v = _t(*_qkv(5, 1, 4, 2, 16, 8))
    before = FA.launches
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        kops.flash_attention(q, k, v, mode="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.blocked_attention(*(t.transpose(1, 2) for t in (q, k, v)), mode="kernel")
    assert FA.launches == before
