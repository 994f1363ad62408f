"""Gradients through the flash attention (``kernels.ops.FlashAttention``,
``kernels.ref.flash_attention_bwd_ref``) against JAX's, on the CPU.

JAX trains through autodiff of its jnp ``blocked_attention`` (its models
never reach the Pallas kernel), so that is the reference:
``flash_attention_bwd_ref`` on the same numpy q, k, v and output gradient,
at causal, sliding-window, softcapped, grouped-query and MLA's (D, Dv) =
(96, 64) shapes, is held to ``jax.grad`` of it at rtol 1e-4 / atol 1e-5
(fp32; the blocked form sums its online softmax in another order), and to
PyTorch's autograd of ``flash_attention_ref`` at rtol 1e-5 / atol 1e-6
(the same fp32 products, contracted in other einsums).
The autograd ``Function`` runs here with the CUDA kernel stood in by the
plain forward (the kernel itself runs only on the card, where
``tests/test_torch_on_card.py`` holds it to autograd of the plain forward
and guards that ``blocked_attention`` keeps a ``grad_fn`` on CUDA
tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import layers as JL
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

torch.set_num_threads(2)

JAX_TOL = dict(rtol=1e-4, atol=1e-5)
REF_TOL = dict(rtol=1e-5, atol=1e-6)
# (B, Hq, Hkv, S, D, Dv, window, softcap)
CASES = [(2, 4, 4, 33, 16, 16, 0, 0.0),    # causal, MHA
         (2, 8, 2, 40, 32, 32, 0, 0.0),    # GQA, groups of 4
         (1, 4, 2, 50, 16, 16, 8, 0.0),    # sliding window
         (2, 4, 2, 37, 16, 16, 0, 2.0),    # softcap (tanh well off linear)
         (1, 4, 1, 45, 32, 32, 12, 2.0),   # window + softcap, one KV head
         (2, 4, 4, 29, 96, 64, 0, 0.0)]    # MLA's (96, 64)
IDS = ["causal", "gqa", "window", "softcap", "window_softcap", "mla_96_64"]


def draw(case, seed=0):
    b, hq, hkv, s, d, dv, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv)).astype(np.float32)
    do = rng.normal(size=(b, s, hq, dv)).astype(np.float32)
    return q, k, v, do


def bhsd(a, requires_grad=False):
    """A (B, S, H, D) numpy array as the (B, H, S, D) view the kernel takes."""
    t = torch.from_numpy(a).transpose(1, 2)
    return t.detach().requires_grad_(True) if requires_grad else t


def port_bwd(case, q, k, v, do):
    window, softcap = case[6], case[7]
    tq, tk, tv, tdo = (bhsd(a) for a in (q, k, v, do))
    return kref.flash_attention_bwd_ref(tq, tk, tv, tdo, window=window, softcap=softcap)


def autograd_of_ref(case, q, k, v, do):
    window, softcap = case[6], case[7]
    tq, tk, tv = (bhsd(a, True) for a in (q, k, v))
    o = kref.flash_attention_ref(tq, tk, tv, window=window, softcap=softcap)
    o.backward(bhsd(do))
    return tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_jax_grad_of_blocked_attention(case):
    q, k, v, do = draw(case)
    window, softcap = case[6], case[7]
    cfg = jget_reduced("chatglm3-6b", dtype="float32")

    def f(q, k, v):  # chunk 16: several q / kv blocks, the band skipping
        return jnp.sum(JL.blocked_attention(q, k, v, cfg, window=window, chunk=16,
                                            softcap=softcap) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = port_bwd(case, q, k, v, do)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **JAX_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_autograd_of_the_plain_forward(case):
    q, k, v, do = draw(case, seed=1)
    for name, g, w in zip("qkv", port_bwd(case, q, k, v, do),
                          autograd_of_ref(case, q, k, v, do)):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"d{name}", **REF_TOL)


def test_bwd_ref_head_blocks_give_one_block_values(monkeypatch):
    """Scores made one KV head at a time (a block budget below one head's
    fp32 scores) give the one-block result."""
    case = CASES[1]
    q, k, v, do = draw(case, seed=2)
    whole = port_bwd(case, q, k, v, do)
    monkeypatch.setattr(kref, "FLASH_BWD_BLOCK_BYTES", 1)
    for g, w in zip(port_bwd(case, q, k, v, do), whole):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **REF_TOL)


def test_bwd_ref_bf16_keeps_dtypes_and_stays_near_fp32():
    """bf16 inputs: gradients come back in bf16, within bf16 rounding of
    the fp32 gradients of the same (bf16-exact) values."""
    case = CASES[3]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in draw(case, seed=3))
    want = port_bwd(case, q, k, v, do)
    window, softcap = case[6], case[7]
    tq, tk, tv, tdo = (bhsd(a).to(torch.bfloat16) for a in (q, k, v, do))
    got = kref.flash_attention_bwd_ref(tq, tk, tv, tdo, window=window, softcap=softcap)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=1.6e-2, atol=1.6e-2)


@pytest.fixture
def stand_in_kernel(monkeypatch):
    """``kernels/flash_attention.py``'s wrapper replaced by the plain forward
    (no grad recorded, as the ctypes launch records none), counting calls."""
    calls = []

    def kernel(q, k, v, causal=True, window=None, softcap=0.0):
        calls.append(q.shape)
        with torch.no_grad():
            return kref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                            softcap=softcap)

    monkeypatch.setattr(kops._flash_kernel, "flash_attention", kernel)
    return calls


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_gives_autograd_of_the_plain_forward(stand_in_kernel, case):
    q, k, v, do = draw(case, seed=4)
    window, softcap = case[6], case[7]
    tq, tk, tv = (bhsd(a, True) for a in (q, k, v))
    o = kops.FlashAttention.apply(tq, tk, tv, True, window, softcap)
    assert o.grad_fn is not None and len(stand_in_kernel) == 1
    o.backward(bhsd(do))
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad),
                          autograd_of_ref(case, q, k, v, do)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"d{name}", **REF_TOL)


def test_dispatch_takes_the_function_only_where_a_gradient_is_needed(
        stand_in_kernel, monkeypatch):
    """On the kernel path ``ops.flash_attention`` wraps the kernel in the
    Function when q, k or v requires grad under grad mode; otherwise (the
    serving path) it calls the wrapper as it is."""
    monkeypatch.setattr(kops, "_resolve", lambda op, mode, t: True)
    q, k, v, _ = draw(CASES[1], seed=5)
    tq, tk, tv = (bhsd(a) for a in (q, k, v))
    assert kops.flash_attention(tq, tk, tv).grad_fn is None
    tk.requires_grad_(True)
    out = kops.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert kops.flash_attention(tq, tk, tv).grad_fn is None
    assert len(stand_in_kernel) == 3
